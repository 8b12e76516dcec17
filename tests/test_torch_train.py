"""The port's teacher-forced forward and train step against the JAX
package's (tiny config, real vocab, f32 on the CPU), and its data and
tensor parallelism in two gloo processes against one process."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.parallel import train as jt
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import (
    params_from_jax, params_to_jax,
)
from whisperjav_tpu_torch.parallel import train as tt

REPO = Path(__file__).resolve().parent.parent
_DIMS = dict(name="ft-tiny", n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_state=64, n_text_head=4,
             n_text_layer=2, n_vocab=51866)
CFG = WhisperConfig(**_DIMS)
TCFG = TorchWhisperConfig(**_DIMS)
LR = 1e-3
WD = 0.01
# f32 on both sides, sums in other orders: logits and the loss within
# 1e-5 relative, each gradient leaf within 1e-4 of its largest |g|
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
# Adam divides by sqrt(v) + eps (1e-8): where a gradient is at rounding
# level, its sign and size are noise, and the update of that element
# anywhere within +-lr a step. So the updated parameters agree within a
# small fraction of lr per step where the first step's |g| is above
# 1e-6, within the most two Adam steps can part (2 lr each, plus the
# decay) everywhere, and on average within 1e-3 lr per leaf.
PARAM_TOL_PER_STEP = 0.05 * LR
CONDITIONED_G = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x).copy(), params)


def _batch(rows=2, seq=12):
    """A seeded batch whose rows have unequal masks (7 and 3 targets)."""
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((rows, CFG.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, CFG.n_vocab, (rows, seq)).astype(np.int32)
    mask = np.zeros((rows, seq), np.float32)
    for r in range(rows):
        mask[r, 3:10 if r % 2 == 0 else 6] = 1.0
    return mel, tokens, mask


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_steps(tree):
    """The JAX package's loss and gradients on the batch, then two steps
    of its train step with optax.adamw (a (1, 1) mesh)."""
    params = jax.tree.map(jnp.asarray, tree)
    mel, tokens, mask = _batch()
    loss, grads = jax.value_and_grad(jt.loss_fn)(
        params, CFG, jnp.asarray(mel), jnp.asarray(tokens),
        jnp.asarray(mask))
    init_fn, step_fn = jt.build_sharded_train_step(
        CFG, jt.make_train_mesh(1), jt.make_optimizer(LR, WD))
    state = init_fn(jax.tree.map(jnp.asarray, tree))
    losses = []
    for _ in range(2):
        state, step_loss = step_fn(state, mel, tokens, mask)
        losses.append(float(step_loss))
    return (float(loss), _flat(jax.tree.map(np.asarray, grads)), losses,
            _flat(jax.tree.map(np.asarray, state.params)))


def _torch_steps(tree, steps=2):
    mesh = tt.make_train_mesh(device="cpu")
    init_fn, step_fn = tt.build_sharded_train_step(
        TCFG, mesh, tt.make_optimizer(LR, WD))
    state = init_fn(params_from_jax(tree, TCFG))
    mel, tokens, mask = _batch()
    losses, grads = [], None
    for _ in range(steps):
        state, loss = step_fn(state, mel, tokens, mask)
        losses.append(loss)
        if grads is None:
            grads = {name.replace(".", "/"): p.grad.numpy().copy()
                     for name, p in state.params.named_parameters()}
    return losses, grads, _flat(params_to_jax(state.params))


def _assert_adam_close(got, want, grads, steps=2):
    """Updated parameters ``got`` against ``want``; ``grads`` are the
    first step's gradients, which tell the conditioned elements."""
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.shape == want[name].shape, name
        err = np.abs(p - want[name])
        conditioned = np.abs(grads[name]) > CONDITIONED_G
        assert err[conditioned].max(initial=0.0) \
            <= steps * PARAM_TOL_PER_STEP, name
        assert err.max() <= steps * 2.1 * LR, name
        assert err.mean() <= 1e-3 * LR, name


def test_forward_logits_match_jax(tree):
    mel, tokens, _ = _batch()
    ref = np.asarray(jm.forward(jax.tree.map(jnp.asarray, tree), CFG,
                                jnp.asarray(mel), jnp.asarray(tokens)))
    model = params_from_jax(tree, TCFG).trainable()
    out = tm.forward(model, torch.from_numpy(mel),
                     torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 12, CFG.n_vocab)
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               atol=LOGIT_TOL * np.abs(ref).max(), rtol=0)


def test_decode_train_matches_jax(tree):
    """decode_train alone, on the same encoder states: the JAX one runs
    its prefill over a cache with unquantised cross K/V."""
    rng = np.random.default_rng(2)
    xa = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    _, tokens, _ = _batch()
    ref = np.asarray(jm.decode_train(jax.tree.map(jnp.asarray, tree), CFG,
                                     jnp.asarray(tokens), jnp.asarray(xa)))
    out = tm.decode_train(params_from_jax(tree, TCFG),
                          torch.from_numpy(tokens).long(),
                          torch.from_numpy(xa)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("how", ["loss_fn", "train_step"])
def test_loss_and_gradients_match_jax(tree, jax_steps, how):
    """The loss and every gradient leaf of ``jax.value_and_grad(loss_fn)``,
    from the port's ``loss_fn`` and from its train step's first step."""
    loss_ref, grads_ref, _, _ = jax_steps
    if how == "loss_fn":
        model = params_from_jax(tree, TCFG).trainable()
        loss = tt.loss_fn(model, *(torch.from_numpy(x) for x in _batch()))
        loss.backward()
        loss = loss.item()
        grads = {name.replace(".", "/"): p.grad.numpy()
                 for name, p in model.named_parameters()}
    else:
        losses, grads, _ = _torch_steps(tree, steps=1)
        loss = losses[0]
    assert abs(loss - loss_ref) <= LOGIT_TOL * abs(loss_ref)
    assert set(grads) == set(grads_ref)
    for name, g in grads.items():
        ref = grads_ref[name]
        assert g.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= GRAD_TOL * scale, name


def test_two_steps_match_jax(tree, jax_steps):
    _, grads_ref, losses_ref, params_ref = jax_steps
    losses, _, params = _torch_steps(tree)
    np.testing.assert_allclose(losses, losses_ref, rtol=LOGIT_TOL)
    assert losses[1] < losses[0]
    _assert_adam_close(params, params_ref, grads_ref)
    # the step moved the weights
    assert not np.allclose(params["decoder/tok_emb"],
                           _flat(tree)["decoder/tok_emb"])


def test_partition_specs_match_jax():
    """The split axis of each leaf is where the JAX PartitionSpec puts
    "model"."""
    def axes(spec):
        return next((i for i, a in enumerate(spec) if a == "model"), None)

    ref = jax.tree.map(axes, jt.param_partition_specs(),
                       is_leaf=lambda x: isinstance(x, jax.sharding
                                                    .PartitionSpec))
    assert tt.param_partition_specs() == ref


def test_trainable_is_f32_with_grads_and_refuses_int8(tree):
    from whisperjav_tpu_torch.models.whisper.quant import (
        quantize_decoder_weights,
    )
    model = params_from_jax(tree, TCFG, dtype=torch.bfloat16).trainable()
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    int8 = params_from_jax(tree, TCFG)
    quantize_decoder_weights(int8)
    with pytest.raises(ValueError, match="int8"):
        int8.trainable()


def test_params_to_jax_inverts_params_from_jax(tree):
    back = _flat(params_to_jax(params_from_jax(tree, TCFG)))
    want = _flat(tree)
    assert set(back) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_one_process_mesh_and_bad_degrees():
    mesh = tt.make_train_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.dp_group is None
    with pytest.raises(ValueError, match="divide"):
        tt.make_train_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match="processes"):
        tt.make_train_mesh(2, device="cpu")


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tt.make_train_mesh(device="cuda")


# ------------------------------------------------- dp=2 and tp=2 (gloo)

_CHILD = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.parallel import train as tt
from whisperjav_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint,
)
port, out = sys.argv[1], sys.argv[4]
rank, tp = int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        world_size=2, rank=rank)
cfg = WhisperConfig(**{dims!r})
tree = load_checkpoint(out + "/init")
mesh = tt.make_train_mesh(2, tp=tp, device="cpu")
init_fn, step_fn = tt.build_sharded_train_step(
    cfg, mesh, tt.make_optimizer({lr!r}, {wd!r}))
state = init_fn(params_from_jax(tree, cfg))
data = np.load(out + "/batch.npz")
losses = []
for _ in range(2):
    state, loss = step_fn(state, data["mel"], data["tokens"], data["mask"])
    losses.append(loss)
whole = tt.full_params(state.params, mesh)
if rank == 0:
    save_checkpoint(out + "/trained", whole)
print("RESULT", json.dumps({{"rank": rank, "losses": losses,
                             "mesh": list(mesh.shape)}}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(script: Path, args_for, timeout=120):
    """Start two children, wait for both (killing both on a timeout or a
    failure), return their outputs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, str(script), *args_for(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("tp", [1, 2], ids=["dp2", "tp2"])
def test_two_processes_match_one(tmp_path, tree, tp):
    """dp=2 (one row each; the rows' masks hold 7 and 3 targets, so the
    per-rank means differ from the global one) and tp=2 (heads, MLP and
    the embedding's features split) in two gloo processes give one
    process's losses and updated parameters."""
    from whisperjav_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    save_checkpoint(tmp_path / "init", tree)
    mel, tokens, mask = _batch()
    np.savez(tmp_path / "batch.npz", mel=mel, tokens=tokens, mask=mask)
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=str(REPO), dims=_DIMS, lr=LR,
                                    wd=WD))
    port = _free_port()
    outs = _run_two(script, lambda r: [str(port), str(r), str(tp),
                                       str(tmp_path)])
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("RESULT"))[7:])
               for out in outs]
    want_losses, grads, want = _torch_steps(tree)
    for res in results:
        assert res["mesh"] == [2 // tp, tp]
        np.testing.assert_allclose(res["losses"], want_losses,
                                   rtol=LOGIT_TOL)
    _assert_adam_close(_flat(load_checkpoint(tmp_path / "trained")), want,
                       grads)
