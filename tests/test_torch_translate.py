"""The port's translation stack against the JAX package on the CPU:
``generate_text`` (the local LM's decode loop), the ``tpu-local`` backend,
the Qwen3 LM converter, ``translate_srt`` with its project files, the
on-device backend's error path, and ``whisperjav-torch-translate``.

Inputs come from numpy seeds or the JAX init at the test widths
(``qwen3-asr-test`` LM: d=256, 4 layers, 8 query / 4 KV heads, vocab
4096), carried across with ``params_from_jax``. Tolerances: f32 on both
sides, sums in other orders -> tokens and lengths identical,
``avg_logprob`` within 1e-5; SRTs, project files and settings byte for
byte (paths aside)."""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.qwen import model as jm
from whisperjav_tpu.modules.srt import Subtitle, save_srt
from whisperjav_tpu.translate import cli as jtcli
from whisperjav_tpu.translate import service as jsvc
from whisperjav_tpu_torch.models.qwen import model as tm
from whisperjav_tpu_torch.models.qwen import weights as tw
from whisperjav_tpu_torch.translate import cli as ttcli
from whisperjav_tpu_torch.translate import service as tsvc

CFG = jm.QWEN_SIZES["qwen3-asr-test"]
TCFG = tm.QWEN_SIZES["qwen3-asr-test"]
LP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_tree():
    """The JAX init's LM alone (no audio tower), q/k/v fused as the
    backends run it, as numpy arrays."""
    tree = jm.init_params(CFG, jax.random.PRNGKey(4))
    tree = {k: v for k, v in tree.items() if k != "audio"}
    return jax.tree.map(np.asarray, jm.fuse_lm_qkv(tree))


def _prompt(n=23, pad_to=32, seed=0):
    ids = np.random.default_rng(seed).integers(
        3, CFG.vocab_size - 1, n).astype(np.int32)
    buf = np.full((1, pad_to), CFG.eos_id, np.int32)
    buf[0, :n] = ids
    return buf, np.asarray([n], np.int32)


@pytest.mark.parametrize("penalty,temperature", [
    (1.0, 0.0), (1.05, 0.0), (1.5, 0.0), (1.05, 0.9)],
    ids=["greedy", "penalty-1.05", "penalty-1.5", "sampled"])
def test_generate_text_matches_jax(lm_tree, penalty, temperature):
    """Greedy with and without the repetition penalty, and sampled with
    the noise JAX's loop draws (split once per step, gumbel from the
    subkey) injected into the port. JAX prefills the bucket-padded
    prompt, the port the real prompt only."""
    buf, n = _prompt()
    max_new, seed = 12, 5
    ref = jm.generate_text(lm_tree, CFG, jnp.asarray(buf), jnp.asarray(n),
                           max_new=max_new, repetition_penalty=penalty,
                           temperature=temperature,
                           rng=jax.random.PRNGKey(seed))
    noise, key = [], jax.random.PRNGKey(seed)
    for _ in range(max_new):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (1, CFG.vocab_size), jnp.float32))))
    model = tw.params_from_jax(lm_tree, TCFG)
    assert not hasattr(model, "audio")
    out = tm.generate_text(model, torch.from_numpy(buf), torch.from_numpy(n),
                           max_new=max_new, repetition_penalty=penalty,
                           temperature=temperature,
                           gumbel=lambda step: noise[step])
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), rtol=0,
                               atol=LP_TOL)
    assert out.tokens.shape == (1, max_new)


def test_generate_text_stops_at_eos_and_pads(lm_tree):
    """With EOS's head column raised every row ends at its first step:
    the tokens are EOS-padded, the length 0, as in the JAX loop."""
    tree = dict(lm_tree)
    head = tree["lm_head"].copy()
    head[:, CFG.eos_id] += 100.0
    tree["lm_head"] = head
    buf, n = _prompt(9, 16, seed=1)
    ref = jm.generate_text(tree, CFG, jnp.asarray(buf), jnp.asarray(n),
                           max_new=10)
    out = tm.generate_text(tw.params_from_jax(tree, TCFG),
                           torch.from_numpy(buf), torch.from_numpy(n),
                           max_new=10)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert (out.tokens.numpy() == CFG.eos_id).all()
    assert int(out.length[0]) == int(ref.length[0]) == 0


def test_generate_text_refuses_ragged_prompts(lm_tree):
    model = tw.params_from_jax(lm_tree, TCFG)
    with pytest.raises(ValueError, match="share one length"):
        tm.generate_text(model, torch.zeros((2, 8), dtype=torch.long),
                         torch.tensor([5, 6]), max_new=2)
    with pytest.raises(ValueError, match="generator"):
        tm.generate_text(model, torch.zeros((1, 8), dtype=torch.long),
                         torch.tensor([5]), max_new=2, temperature=0.5)


def test_local_backend_matches_jax(lm_tree):
    """The tpu-local backends with the fallback tokenizer: the chat
    template, generation and decoding give the same string."""
    from whisperjav_tpu.models.qwen.tokenizer import QwenTokenizer as JTok
    from whisperjav_tpu.translate.local_backend import TpuLocalBackend
    from whisperjav_tpu_torch.models.qwen.tokenizer import (
        QwenTokenizer as TTok,
    )
    from whisperjav_tpu_torch.translate.local_backend import (
        LocalLMBackend, cap_batch_size_for_context,
    )
    from whisperjav_tpu.translate.local_backend import (
        cap_batch_size_for_context as jcap,
    )
    prompt = "Translate:\n---\n1: こんにちは\n2: ありがとう"
    ref = TpuLocalBackend(params=lm_tree, cfg=CFG, tokenizer=JTok(),
                          max_new_tokens=10)(prompt)
    backend = LocalLMBackend(params=tw.params_from_jax(lm_tree, TCFG),
                             tokenizer=TTok(), max_new_tokens=10,
                             device="cpu")
    assert backend(prompt) == ref and len(ref) > 0
    # a JAX-layout tree with its config is moved to the device too
    again = LocalLMBackend(params=lm_tree, cfg=TCFG, tokenizer=TTok(),
                           max_new_tokens=10, device="cpu")
    assert again(prompt) == ref
    assert backend.context_window == 32_768
    for n_ctx in (2000, 8192, 32_768):
        assert cap_batch_size_for_context(30, n_ctx) == jcap(30, n_ctx)


def test_local_backend_needs_weights_and_tokenizer(lm_tree):
    from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend
    with pytest.raises(ValueError, match="checkpoint"):
        LocalLMBackend(device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        LocalLMBackend(params=lm_tree, cfg=TCFG, device="cpu")


def _save_twin(tmp_path, kind):
    """A tiny transformers causal LM (Qwen3, or Qwen2 without q/k norms)
    saved to a directory, from a fixed seed."""
    import transformers
    torch.manual_seed(0)
    common = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, tie_word_embeddings=False)
    if kind == "qwen3":
        model = transformers.Qwen3ForCausalLM(
            transformers.Qwen3Config(head_dim=16, **common))
    else:
        model = transformers.Qwen2ForCausalLM(
            transformers.Qwen2Config(**common))
    path = tmp_path / kind
    model.save_pretrained(str(path))
    return str(path)


def test_load_lm_matches_jax_converter(tmp_path):
    """``load_lm`` on a saved Qwen3 twin gives the JAX converter's
    config and tree, leaf for leaf; ``lm_params_from_state_dict`` on the
    state dict alone agrees (with the tied head where ``lm_head`` is
    absent); the port's backend then runs on it."""
    from whisperjav_tpu.models.qwen import convert as jconv
    from whisperjav_tpu_torch.models.qwen import convert as tconv
    import dataclasses
    path = _save_twin(tmp_path, "qwen3")
    tcfg, tree = tconv.load_lm(path)
    jcfg, jtree = jconv.load_lm(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert "audio" not in tree
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [k for k, _ in flat_t] == [k for k, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    import transformers
    sd = transformers.AutoModelForCausalLM.from_pretrained(
        path, local_files_only=True).state_dict()
    sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    got = tconv.lm_params_from_state_dict(sd, tcfg)
    want = jconv.lm_params_from_state_dict(sd, jcfg)
    np.testing.assert_array_equal(got["lm_head"], want["lm_head"])
    np.testing.assert_array_equal(got["lm_head"], got["tok_emb"].T)
    model = tw.params_from_jax(tree, tcfg)
    buf = np.arange(3, 12, dtype=np.int64)[None]
    out = tm.generate_text(model, torch.from_numpy(buf), torch.tensor([9]),
                           max_new=4)
    ref = jm.generate_text(jtree, jcfg, jnp.asarray(buf, jnp.int32),
                           jnp.asarray([9], jnp.int32), max_new=4)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


def test_load_lm_refuses_a_qwen2_checkpoint(tmp_path):
    from whisperjav_tpu.models.qwen import convert as jconv
    from whisperjav_tpu_torch.models.qwen import convert as tconv
    path = _save_twin(tmp_path, "qwen2")
    for conv in (tconv, jconv):
        with pytest.raises(ValueError, match="q/k-norm"):
            conv.load_lm(path)


def _srt(path, n=23, seed=0):
    """``n`` cues with pauses, one long enough (70 s) to start a second
    scene."""
    rng = np.random.default_rng(seed)
    subs, t = [], 0.0
    for i in range(n):
        t += rng.uniform(0.2, 2.5) + (70.0 if i == 12 else 0.0)
        d = rng.uniform(0.8, 3.0)
        subs.append(Subtitle(i + 1, round(t, 3), round(t + d, 3),
                             f"せりふ{i}番" + "あ" * int(rng.integers(1, 6))))
        t += d
    save_srt(path, subs)
    return path


def _fake_llm(prompt):
    """A deterministic provider: each numbered line back reversed, and a
    summary of the batch's first number."""
    lines = prompt.split("---\n", 1)[-1].splitlines()
    body = [f"{ln.split(':', 1)[0]}: {ln.split(':', 1)[1].strip()[::-1]}"
            for ln in lines]
    return "\n".join(body) + f"\n<summary>batch {lines[0].split(':')[0]}" \
        "</summary>"


def _run_both(tmp_path, **kw):
    """translate_srt of one SRT by each package in its own directory;
    the output SRT and the project file (source path aside) of each."""
    out = {}
    for side, svc in (("jax", jsvc), ("torch", tsvc)):
        d = tmp_path / side
        d.mkdir(parents=True, exist_ok=True)
        srt = _srt(d / "clip.ja.whisperjav.srt")
        path = svc.translate_srt(srt, max_batch_size=5, **kw)
        proj = json.loads((d / "clip.ja.whisperjav.wjtrans.json")
                          .read_text(encoding="utf-8"))
        proj.pop("source")
        out[side] = (path.name, path.read_bytes(), proj)
    return out


@pytest.mark.parametrize("kw", [
    {"provider": "identity"},
    {"provider": "gpt", "call_fn": _fake_llm},
    {"provider": "tpu-local", "call_fn": _fake_llm,
     "movie_context": "Title: x", "target_language": "German"},
], ids=["identity", "injected", "on-device-injected"])
def test_translate_srt_matches_jax(tmp_path, kw):
    out = _run_both(tmp_path, **kw)
    assert out["torch"] == out["jax"]
    proj = out["torch"][2]
    assert len(proj["batches"]) >= 5 and \
        {b["scene"] for b in proj["batches"]} == {0, 1}
    assert all(b["status"] == "done" for b in proj["batches"])


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_a_project_resumes_in_the_other_package(tmp_path, first, second):
    """One package stops after two batches (its provider fails from the
    third on, which keeps source text); the other resumes the same
    project and sends only the batches left. The result equals one
    uninterrupted run."""
    svc = {"jax": jsvc, "torch": tsvc}
    full = _run_both(tmp_path / "full", provider="gpt",
                     call_fn=_fake_llm)["jax"]
    srt = _srt(tmp_path / "clip.ja.whisperjav.srt")
    calls = []

    def failing(prompt):
        calls.append(prompt)
        if len(calls) > 2:
            raise RuntimeError("provider down")
        return _fake_llm(prompt)

    svc[first].translate_srt(srt, provider="gpt", call_fn=failing,
                             max_batch_size=5)
    proj = json.loads(srt.with_suffix(".wjtrans.json").read_text())
    assert [b["status"] for b in proj["batches"]].count("done") == 2
    resumed = []

    def counting(prompt):
        resumed.append(prompt)
        return _fake_llm(prompt)

    path = svc[second].translate_srt(srt, provider="gpt", call_fn=counting,
                                     max_batch_size=5)
    assert len(resumed) == len(proj["batches"]) - 2
    assert path.read_bytes() == full[1]


def test_on_device_backend_errors_raise_in_the_port(tmp_path):
    """An error from the on-device backend's call raises in the port once
    the project is saved; the JAX package keeps the source text and
    returns."""
    def broken(prompt):
        raise RuntimeError("CUDA error: an illegal memory access")

    srt_t = _srt(tmp_path / "t" / "clip.ja.whisperjav.srt")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsvc.translate_srt(srt_t, provider="tpu-local", call_fn=broken)
    proj = json.loads(srt_t.with_suffix(".wjtrans.json").read_text())
    assert proj["batches"][0]["status"] == "failed"
    assert not (tmp_path / "t" / "clip.ja.en.srt").exists()
    # a network provider's failure keeps the source text, as in JAX
    out = tsvc.translate_srt(srt_t, provider="gpt", call_fn=broken)
    assert out.read_text(encoding="utf-8") == srt_t.read_text(
        encoding="utf-8")
    srt_j = _srt(tmp_path / "j" / "clip.ja.whisperjav.srt")
    out = jsvc.translate_srt(srt_j, provider="tpu-local", call_fn=broken)
    assert out.read_text(encoding="utf-8") == srt_j.read_text(
        encoding="utf-8")


def test_translate_with_config_matches_jax(tmp_path):
    out = {}
    for side, svc in (("jax", jsvc), ("torch", tsvc)):
        srt = _srt(tmp_path / side / "clip.srt", seed=3)
        path = svc.translate_with_config({
            "input": str(srt), "provider": "identity",
            "target_language": "French", "scene_threshold": 30.0})
        out[side] = (path.name, path.read_bytes())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "clip.fr.srt"


@pytest.mark.parametrize("argv", [
    ["--show-settings"],
    ["--show-settings", "--provider", "gpt", "--tone", "pornify",
     "--movie-title", "T"],
    ["--save", "--provider", "deepseek", "--max-batch-size", "12"],
])
def test_translate_cli_settings_match(tmp_path, monkeypatch, capsys, argv):
    """``--show-settings`` and ``--save`` print and persist what the JAX
    CLI does, under one ``WJAV_CONFIG_DIR``; a file one saved is read by
    the other."""
    out = {}
    for side, mod in (("jax", jtcli), ("torch", ttcli)):
        monkeypatch.setenv("WJAV_CONFIG_DIR", str(tmp_path / side))
        assert mod.main(list(argv)) == 0
        text = capsys.readouterr().out.replace(str(tmp_path / side), "<d>")
        saved = tmp_path / side / "translate" / "settings.json"
        out[side] = (text, saved.read_text() if saved.exists() else None)
    assert out["torch"] == out["jax"]
    monkeypatch.setenv("WJAV_CONFIG_DIR", str(tmp_path / "jax"))
    assert ttcli.main(["--show-settings"]) == 0
    shown = json.loads(capsys.readouterr().out)
    if "--save" in argv:
        assert shown["provider"] == "deepseek"


@pytest.mark.parametrize("ops", [
    [["show"]],
    [["merge-scenes", "0", "1"], ["show"]],
    [["split-batch", "0", "0", "2"], ["reset-batch", "0", "1"]],
    [["set-synopsis", "a", "story"], ["set-scene-summary", "1", "later"]],
    [["move-lines", "0", "0", "0", "1", "2,3"]],
    [["merge-batches", "0", "0", "9"]],
], ids=["show", "merge-scenes", "split-reset", "summaries", "move",
        "bad-batch"])
def test_translate_cli_edit_matches(tmp_path, monkeypatch, capsys, ops):
    """``--edit`` verbs give the same printed tree, return code and
    project file as the JAX CLI's, applied in turn to copies of one
    project."""
    monkeypatch.setenv("WJAV_CONFIG_DIR", str(tmp_path / "cfg"))
    seed = tmp_path / "seed"
    seed.mkdir()
    srt = _srt(seed / "clip.srt")
    jsvc.translate_srt(srt, provider="gpt", call_fn=_fake_llm,
                       max_batch_size=5)
    out = {}
    for side, mod in (("jax", jtcli), ("torch", ttcli)):
        d = tmp_path / side
        shutil.copytree(seed, d)
        rcs, texts = [], []
        for op in ops:
            rcs.append(mod.main(["-i", str(d / "clip.srt"),
                                 "--max-batch-size", "5", "--edit", *op]))
            cap = capsys.readouterr()
            texts.append((cap.out + cap.err).replace(str(d), "<d>"))
        proj = json.loads((d / "clip.wjtrans.json").read_text())
        proj.pop("source")
        out[side] = (rcs, texts, proj)
    assert out["torch"] == out["jax"]
