"""Single-page GUI app (inline HTML/JS, no build step).

The port's copy of ``whisperjav_tpu/gui/app_page.py``: the same DOM ids
and the same ``fetch`` routes; only the title names the PyTorch build.

Product surface (reference: webview_gui/assets/app.js — sampled, not
copied): per-file job queue with live status/stage chips, per-job log
panel fed by /api/logs, ensemble pass-editor, preset CRUD against
/api/presets. The page never talks to a model — every action builds CLI
argv server-side (gui/server.py builds the CLI argv)."""

APP_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>WhisperJAV PyTorch</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background: #14161a;
         color: #e8e8e8; }
  header { padding: 14px 22px; background: #1d2026;
           border-bottom: 1px solid #2c313a; }
  h1 { font-size: 17px; margin: 0; font-weight: 600; }
  main { display: grid; grid-template-columns: 360px 1fr; gap: 18px;
         padding: 18px 22px; }
  .panel { background: #1d2026; border: 1px solid #2c313a;
           border-radius: 8px; padding: 16px; }
  label { display: block; font-size: 12px; color: #9aa4b2;
          margin: 10px 0 3px; }
  input, select { width: 100%; box-sizing: border-box; padding: 6px 8px;
                  background: #14161a; color: #e8e8e8;
                  border: 1px solid #2c313a; border-radius: 5px; }
  .row { display: flex; gap: 10px; }
  .row > div { flex: 1; }
  button { margin-top: 14px; padding: 8px 18px; border-radius: 6px;
           border: none; cursor: pointer; font-weight: 600; }
  #start { background: #3b82f6; color: white; }
  #cancel { background: #3a3f48; color: #e8e8e8; }
  #logs { font-family: ui-monospace, monospace; font-size: 12px;
          white-space: pre-wrap; background: #101214; border-radius: 6px;
          padding: 12px; height: 42vh; overflow-y: auto; }
  #status { font-size: 12px; color: #9aa4b2; margin-left: 10px; }
  .chk { display: flex; align-items: center; gap: 6px; margin-top: 8px;
         font-size: 13px; }
  .chk input { width: auto; }
  #queue { width: 100%; border-collapse: collapse; font-size: 12px;
           margin-bottom: 12px; }
  #queue th { text-align: left; color: #9aa4b2; font-weight: 500;
              padding: 4px 8px; border-bottom: 1px solid #2c313a; }
  #queue td { padding: 5px 8px; border-bottom: 1px solid #22262d;
              cursor: pointer; }
  #queue tr.sel td { background: #22262d; }
  .chip { display: inline-block; padding: 1px 8px; border-radius: 9px;
          font-size: 11px; font-weight: 600; }
  .chip.queued { background: #3a3f48; }
  .chip.running { background: #2563eb; }
  .chip.done { background: #166534; }
  .chip.failed { background: #991b1b; }
  .chip.cancelled { background: #3a3f48; color: #9aa4b2; }
  #ensemble_panel { display: none; border: 1px solid #2c313a;
                    border-radius: 6px; padding: 4px 10px 10px;
                    margin-top: 8px; }
  details.adv { margin-top: 6px; border: 1px solid #2c313a;
                border-radius: 6px; padding: 4px 10px 8px; }
  details.adv summary { font-size: 12px; color: #9aa4b2; cursor: pointer; }
  details.adv[hidden] { display: none; }
  .advgrid { display: grid; grid-template-columns: 1fr 1fr; gap: 0 10px; }
  .advgrid label { margin-top: 6px; }
  .advgrid .chk { margin-top: 10px; }
</style>
</head>
<body>
<header><h1>WhisperJAV <span style="color:#3b82f6">PyTorch</span>
  <span id="status"></span>
  <span id="version" style="float:right;font-size:12px;color:#8b8f98"></span>
</h1></header>
<main>
  <div class="panel">
    <label>Input files / directory / glob</label>
    <input id="inputs" placeholder="/data/videos or /data/*.wav">
    <label>Output directory</label>
    <input id="output_dir" value="./output">
    <div class="row">
      <div><label>Mode</label><select id="mode"></select></div>
      <div><label>Sensitivity</label><select id="sensitivity"></select></div>
    </div>
    <div class="row">
      <div><label>VAD</label><select id="vad_backend"></select></div>
      <div><label>Scenes</label><select id="scene_backend"></select></div>
    </div>
    <details class="adv" id="adv_vad" hidden><summary>VAD options</summary>
      <div class="advgrid" id="adv_vad_fields"></div></details>
    <details class="adv" id="adv_scene" hidden><summary>Scene options</summary>
      <div class="advgrid" id="adv_scene_fields"></div></details>
    <div class="row">
      <div><label>Enhancer</label><select id="enhancer"></select></div>
      <div><label>Subs language</label>
        <select id="subs_language">
          <option value="japanese">japanese</option>
          <option value="english-direct">english-direct</option>
        </select></div>
    </div>
    <details class="adv" id="adv_enhancer" hidden>
      <summary>Enhancer options</summary>
      <div class="advgrid" id="adv_enhancer_fields"></div></details>
    <label>Model checkpoint (local dir, optional)</label>
    <input id="checkpoint" placeholder="/models/whisper-large-v2">
    <div class="row">
      <div><label>Translate provider</label>
        <select id="translate"></select></div>
      <div><label>Batch size</label>
        <input id="batch_size" type="number" value="32"></div>
    </div>
    <div class="chk"><input type="checkbox" id="ensemble">
      <span>Two-pass ensemble</span></div>
    <div id="ensemble_panel">
      <div class="row">
        <div><label>Pass 1 model</label><input id="pass1_model"
          placeholder="(mode default)"></div>
        <div><label>Pass 1 sensitivity</label>
          <select id="pass1_sensitivity"></select></div>
      </div>
      <div class="row">
        <div><label>Pass 2 model</label><input id="pass2_model"
          placeholder="(mode default)"></div>
        <div><label>Pass 2 sensitivity</label>
          <select id="pass2_sensitivity"></select></div>
      </div>
      <label>Merge strategy</label>
      <select id="merge_strategy"></select>
    </div>
    <div class="chk"><input type="checkbox" id="skip_existing" checked>
      <span>Skip existing outputs</span></div>
    <div class="chk"><input type="checkbox" id="make_vtt">
      <span>Also write VTT</span></div>
    <div class="chk"><input type="checkbox" id="word_timestamps">
      <span>Word-level timestamp refinement</span></div>
    <label>Preset</label>
    <div class="row">
      <div><select id="preset"><option value="">(none)</option></select></div>
      <div><input id="preset_name" placeholder="save as…"></div>
    </div>
    <div class="row">
      <div><button id="save_preset" style="background:#3a3f48;color:#e8e8e8">
        Save preset</button></div>
      <div><button id="delete_preset" style="background:#3a3f48;color:#e8e8e8">
        Delete</button></div>
    </div>
    <button id="start">Add to queue</button>
    <button id="cancel">Cancel all</button>
  </div>
  <div class="panel">
    <table id="queue">
      <thead><tr><th>#</th><th>File</th><th>Status</th><th>Stage</th>
        <th>Result</th></tr></thead>
      <tbody id="queue_body"></tbody>
    </table>
    <div id="logs">ready.</div>
  </div>
</main>
<script>
const $ = id => document.getElementById(id);
let next = 0, selJob = null, followRunning = true, timer = null;

async function loadVersion() {
  const v = await (await fetch('/api/version')).json();
  $('version').textContent = 'v' + v.version +
    (v.update_available ? ' — update available: ' + v.latest : '');
}

async function loadSchema() {
  const s = await (await fetch('/api/schema')).json();
  const fill = (id, items, labels) => {
    const sel = $(id); sel.innerHTML = '';
    for (const v of items) {
      const o = document.createElement('option');
      o.value = v; o.textContent = labels && labels[v] ? v + ' — ' + labels[v] : (v || '(none)');
      sel.appendChild(o);
    }
  };
  fill('mode', Object.keys(s.modes));
  $('mode').value = 'balanced';
  fill('sensitivity', s.sensitivities); $('sensitivity').value = 'balanced';
  fill('pass1_sensitivity', [''].concat(s.sensitivities));
  fill('pass2_sensitivity', [''].concat(s.sensitivities));
  fill('vad_backend', [''].concat(s.vad_backends));
  fill('scene_backend', [''].concat(s.scene_backends));
  fill('enhancer', [''].concat(s.enhancers));
  fill('translate', s.translate_providers);
  fill('merge_strategy', [''].concat(s.merge_strategies));
}

$('ensemble').onchange = () =>
  $('ensemble_panel').style.display = $('ensemble').checked ? 'block' : 'none';

// ---- schema-driven per-backend advanced forms (server introspects the
// backend config dataclasses at /api/component_schema)
const ADV = [   // [select id, schema component type, options() key]
  ['vad_backend', 'segmenter', 'vad_args'],
  ['scene_backend', 'scene', 'scene_args'],
  ['enhancer', 'enhancer', 'enhancer_args'],
];
const advDefaults = {};   // options key → {field: default}

async function renderAdv(selId, ctype, okey) {
  const panel = $('adv_' + (okey === 'enhancer_args' ? 'enhancer'
                            : okey.replace('_args', '')));
  const holder = panel.querySelector('.advgrid');
  holder.innerHTML = ''; advDefaults[okey] = {};
  const name = $(selId).value;
  if (!name || name === 'none') { panel.hidden = true; return; }
  const r = await (await fetch('/api/component_schema?type=' + ctype +
                               '&name=' + encodeURIComponent(name))).json();
  if (!r.success || !r.fields.length) { panel.hidden = true; return; }
  panel.hidden = false;
  for (const f of r.fields) {
    advDefaults[okey][f.name] = f.default;
    const id = 'advf_' + okey + '_' + f.name;
    const div = document.createElement('div');
    if (f.type === 'bool') {
      div.className = 'chk';
      div.innerHTML = '<input type="checkbox" id="' + id + '"' +
        (f.default ? ' checked' : '') + '><span>' + f.name + '</span>';
    } else {
      const num = f.type === 'int' || f.type === 'float';
      div.innerHTML = '<label>' + f.name + '</label><input id="' + id +
        '"' + (num ? ' type="number" step="any"' : '') +
        ' value="' + (f.default === null ? '' : f.default) + '">';
    }
    holder.appendChild(div);
  }
}

function collectAdv(o) {
  for (const [, , okey] of ADV) {
    const defs = advDefaults[okey] || {};
    const args = {};
    for (const [name, def] of Object.entries(defs)) {
      const el = $('advf_' + okey + '_' + name);
      if (!el) continue;
      const v = el.type === 'checkbox' ? el.checked : el.value;
      if (String(v) !== String(def === null ? '' : def)) args[name] = v;
    }
    if (Object.keys(args).length) o[okey] = args;
  }
}

for (const [selId, ctype, okey] of ADV)
  $(selId).addEventListener('change', () => renderAdv(selId, ctype, okey));

function options() {
  const o = { inputs: $('inputs').value.trim() };
  for (const k of ['output_dir','mode','sensitivity','vad_backend',
                   'scene_backend','enhancer','subs_language','checkpoint',
                   'translate','batch_size','pass1_model','pass2_model',
                   'pass1_sensitivity','pass2_sensitivity','merge_strategy'])
    if ($(k).value) o[k] = $(k).value;
  for (const k of ['ensemble','skip_existing','make_vtt','word_timestamps'])
    o[k] = $(k).checked;
  collectAdv(o);
  return o;
}

function chip(st) { return '<span class="chip ' + st + '">' + st + '</span>'; }

async function refresh() {
  const q = await (await fetch('/api/queue')).json();
  const body = $('queue_body'); body.innerHTML = '';
  let running = null;
  for (const j of q.jobs) {
    if (j.status === 'running') running = j.id;
    const tr = document.createElement('tr');
    if (j.id === selJob) tr.className = 'sel';
    const res = j.result && j.result.srt
      ? j.result.subtitles + ' subs · RTF ' + j.result.rtf_x + 'x' : '';
    tr.innerHTML = '<td>' + j.id + '</td><td>' +
      j.file.split('/').pop() + '</td><td>' + chip(j.status) +
      '</td><td>' + (j.stage || '') + '</td><td>' + res + '</td>';
    tr.onclick = () => { selJob = j.id; followRunning = false; next = 0;
                         $('logs').textContent = ''; };
    body.appendChild(tr);
  }
  if (followRunning && running !== null && running !== selJob) {
    selJob = running; next = 0; $('logs').textContent = '';
  }
  $('status').textContent = '· ' + q.status;
  if (selJob !== null) {
    const r = await (await fetch('/api/logs?job=' + selJob +
                                 '&since=' + next)).json();
    if (r.lines.length) {
      $('logs').textContent += r.lines.join('\\n') + '\\n';
      $('logs').scrollTop = $('logs').scrollHeight;
    }
    next = r.next;
  }
  clearTimeout(timer);
  timer = setTimeout(refresh, q.status === 'running' ? 700 : 2500);
}

$('start').onclick = async () => {
  if (!$('inputs').value.trim()) { alert('enter an input path'); return; }
  const r = await (await fetch('/api/start', { method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(options()) })).json();
  if (!r.ok) { alert(r.error); return; }
  followRunning = true;
  refresh();
};
$('cancel').onclick = () => fetch('/api/cancel', { method: 'POST',
  headers: {'Content-Type': 'application/json'}, body: '{}' });

async function loadPresets() {
  const ps = await (await fetch('/api/presets')).json();
  const sel = $('preset'); sel.innerHTML = '<option value="">(none)</option>';
  for (const name of Object.keys(ps)) {
    const o = document.createElement('option');
    o.value = name; o.textContent = name;
    sel.appendChild(o);
  }
  sel.onchange = () => {
    const p = ps[sel.value];
    if (!p) return;
    for (const [k, v] of Object.entries(p)) {
      const el = $(k);
      if (!el) continue;
      if (el.type === 'checkbox') el.checked = !!v;
      else el.value = v;
    }
    $('ensemble').onchange();
  };
}
$('save_preset').onclick = async () => {
  const name = $('preset_name').value.trim();
  if (!name) { alert('enter a preset name'); return; }
  const r = await (await fetch('/api/presets', { method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({ name, options: options() }) })).json();
  if (!r.ok) { alert(r.error); return; }
  loadPresets();
};
$('delete_preset').onclick = async () => {
  const name = $('preset').value;
  if (!name) return;
  await fetch('/api/presets', { method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({ name, delete: true }) });
  loadPresets();
};

loadSchema();
loadVersion();
loadPresets();
refresh();
</script>
</body>
</html>
"""
