"""Fine-tuning train step with data and tensor parallelism.

Counterpart of ``whisperjav_tpu/parallel/train.py``, in PyTorch's idiom:
one process per GPU (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``), the collectives written out where GSPMD inserts them in
the JAX package. The (dp, tp) mesh lays the ranks out row-major as the
JAX mesh lays out its devices, rank = d * tp + t: the ranks of one row
(the same d) form a tensor-parallel group, those of one column (the same
t) a data-parallel group.

Tensor parallelism follows the JAX package's PartitionSpecs
(:func:`param_partition_specs`), as Megatron splits a transformer:

- q/k/v, the MLP's up-projection and the cross-attention's q/k/v split on
  their output features (column parallel, each rank a share of the
  heads), their biases with them;
- the attention outputs and the MLP's down-projection split on their
  input features (row parallel): each rank's partial product is summed
  over the group before the replicated bias;
- ``tok_emb`` splits on its feature axis: the embedding gathers the
  features, the tied head sums its partial logits;
- every other leaf is replicated, and so are its gradients.

Data parallelism splits the batch's rows over the dp ranks, sums the
gradients over them, and takes the loss as the masked mean over the
whole batch: the sums of ``nll * mask`` and of ``mask`` are summed over
the dp ranks, as the JAX step's mean over its global batch.

One process with no such environment trains on one device with the mesh
(1, 1) and starts no process group.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.model import (
    Replicated, Whisper, forward,
)
from whisperjav_tpu_torch.models.whisper.weights import nest, to_numpy
from whisperjav_tpu_torch.pipelines.engine import resolve_device


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _block_specs(cross: bool) -> Dict[str, Optional[int]]:
    specs = {
        "ln1_s": None, "ln1_b": None,
        "wq": 2, "bq": 1, "wk": 2, "wv": 2, "bv": 1,
        "wo": 1, "bo": None,
        "ln2_s": None, "ln2_b": None,
        "w1": 2, "b1": 1, "w2": 1, "b2": None,
    }
    if cross:
        specs.update({
            "lnx_s": None, "lnx_b": None,
            "cwq": 2, "cbq": 1, "cwk": 2, "cwv": 2, "cbv": 1,
            "cwo": 1, "cbo": None,
        })
    return specs


def param_partition_specs() -> Dict[str, Dict]:
    """The axis of each leaf of the (float) Whisper tree that splits over
    the tensor-parallel ranks, None where the leaf is replicated: the
    position of "model" in the JAX package's PartitionSpec of the leaf
    (leaves stack on a layer axis, matrices are (in, out))."""
    return {
        "encoder": {
            "conv1_w": None, "conv1_b": None,
            "conv2_w": None, "conv2_b": None,
            "pos": None,
            "blocks": _block_specs(cross=False),
            "ln_s": None, "ln_b": None,
        },
        "decoder": {
            "tok_emb": 1,
            "pos_emb": None,
            "blocks": _block_specs(cross=True),
            "ln_s": None, "ln_b": None,
        },
    }


def _split_axes() -> Dict[str, Optional[int]]:
    """:func:`param_partition_specs` by state-dict name."""
    out = {}
    for part, tree in param_partition_specs().items():
        for name, axis in tree.items():
            if name == "blocks":
                out.update({f"{part}.blocks.{k}": v
                            for k, v in axis.items()})
            else:
                out[f"{part}.{name}"] = axis
    return out


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@dataclass
class TrainMesh:
    """The (dp, tp) layout of the ranks, this rank's place in it, its
    process groups (None on one process) and its device."""
    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dp, self.tp)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def _train_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_train_mesh(n_devices: Optional[int] = None,
                    tp: Optional[int] = None,
                    device="cuda") -> TrainMesh:
    """The (data, model) mesh over the processes; ``tp`` defaults to 2
    when the world is even and at least 2, else 1, as in the JAX package.

    Joins the process group the environment describes (``torchrun``:
    NCCL on CUDA, gloo on the CPU) unless one is already up; with no
    such environment the mesh is (1, 1) on ``device`` and no group
    starts. A bare "cuda" device becomes ``cuda:$LOCAL_RANK``."""
    dev = _train_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        world = dist.get_world_size()
    elif world > 1:
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://")
    n = n_devices or world
    if n != world:
        raise ValueError(f"a train mesh over {n} device(s) needs as many "
                         f"processes, got a world of {world}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tensor-parallel degree {tp} does not divide "
                         f"{n} device(s)")
    dp = n // tp
    if world == 1:
        return TrainMesh(1, 1, 0, dev)
    rank = dist.get_rank()
    mesh = TrainMesh(dp, tp, rank, dev)
    # every rank creates every group, in one order
    for d in range(dp):
        group = dist.new_group([d * tp + t for t in range(tp)])
        if d == mesh.dp_rank:
            mesh.tp_group = group
    for t in range(tp):
        group = dist.new_group([d * tp + t for d in range(dp)])
        if t == mesh.tp_rank:
            mesh.dp_group = group
    return mesh


# ---------------------------------------------------------------------------
# tensor-parallel hooks (autograd through the collectives)
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather of the last axis forward; backward keeps this rank's
    slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None, None, None


class TensorParallel(Replicated):
    """The hooks of ``models/whisper/model.py:forward`` over a
    tensor-parallel group of ``size`` ranks."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def copy(self, x):
        return _Copy.apply(x, self.group)

    def reduce(self, x):
        return _Reduce.apply(x, self.group)

    def gather(self, x):
        return _Gather.apply(x, self.group, self.rank, self.size)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _check_divisible(config: WhisperConfig, tp: int) -> None:
    for what, n in (("encoder heads", config.n_audio_head),
                    ("decoder heads", config.n_text_head),
                    ("features", config.n_text_state)):
        if n % tp:
            raise ValueError(f"tensor-parallel degree {tp} does not "
                             f"divide the {what} ({n})")


def shard_params(model: Whisper, mesh: TrainMesh) -> Whisper:
    """This rank's shard of a whole float model, on the mesh's device:
    each split leaf's slice along its axis (:func:`param_partition_specs`),
    every other leaf whole; a new :class:`Whisper`, so the caller's model
    is left as it was."""
    axes = _split_axes()
    flat = {}
    for name, t in model.state_dict().items():
        axis = axes[name]
        if axis is not None and mesh.tp > 1:
            width = t.shape[axis] // mesh.tp
            t = t.narrow(axis, mesh.tp_rank * width, width)
        flat[name] = t.detach().to(mesh.device, copy=True)
    return Whisper(model.config, nest(flat))


def full_params(model: Whisper, mesh: TrainMesh) -> Dict:
    """The whole parameter tree (the JAX layout, numpy leaves) from this
    rank's shard: split leaves are gathered over the tensor-parallel
    group. Every rank of the group must call it."""
    axes = _split_axes()
    flat = {}
    for name, t in model.state_dict().items():
        axis = axes[name]
        if axis is not None and mesh.tp > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.tp)]
            dist.all_gather(parts, t.contiguous(), group=mesh.tp_group)
            t = torch.cat(parts, dim=axis)
        flat[name] = to_numpy(t)
    return nest(flat)


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """This rank's parameter shard (a trainable :class:`Whisper`), its
    optimizer and the steps taken. After a step each parameter's
    ``.grad`` holds that step's gradient (summed over dp)."""
    params: Whisper
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01):
    """AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8,
    decoupled weight decay on every leaf, biases and LayerNorm
    included): a callable from parameters to the optimizer."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def masked_nll_sums(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                    loss_mask: torch.Tensor, tp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sums of the next-token NLL under the mask and of the mask, for
    the rows given (targets ``tokens[:, 1:]``, mask ``loss_mask[:, 1:]``)."""
    logits = forward(model, mel, tokens[:, :-1], tp=tp)
    targets = tokens[:, 1:].long()
    mask = loss_mask[:, 1:].float()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def loss_fn(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced next-token cross-entropy, masked, on one device."""
    total, count = masked_nll_sums(model, mel, tokens, loss_mask)
    return total / torch.clamp(count, min=1.0)


def _rows(x, mesh: TrainMesh, dtype) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.dp:
        raise ValueError(f"batch of {x.shape[0]} does not split over "
                         f"{mesh.dp} data-parallel rank(s)")
    n = x.shape[0] // mesh.dp
    x = x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
    return x.to(device=mesh.device, dtype=dtype)


def build_sharded_train_step(config: WhisperConfig, mesh: TrainMesh,
                             optimizer=None):
    """Returns ``(init_fn, run_step)``.

    ``init_fn(model) -> TrainState``: this rank's trainable f32 shard of
    a whole model (the model itself is left as it was) and its optimizer.
    ``run_step(state, mel, tokens, loss_mask) -> (state, loss)``: one
    step on the whole batch (numpy or tensors; each dp rank takes its
    rows), the loss a float, the masked mean over the whole batch before
    the update, as the JAX step returns it.
    """
    if optimizer is None:
        optimizer = make_optimizer()
    _check_divisible(config, mesh.tp)
    tp = (TensorParallel(mesh.tp_group, mesh.tp_rank, mesh.tp)
          if mesh.tp > 1 else Replicated())

    def init_fn(model: Whisper) -> TrainState:
        params = shard_params(model, mesh).trainable()
        return TrainState(params, optimizer(list(params.parameters())))

    def run_step(state: TrainState, mel, tokens, loss_mask):
        mel = _rows(mel, mesh, torch.float32)
        tokens = _rows(tokens, mesh, torch.long)
        loss_mask = _rows(loss_mask, mesh, torch.float32)
        state.optimizer.zero_grad(set_to_none=True)
        total, count = masked_nll_sums(state.params, mel, tokens,
                                       loss_mask, tp=tp)
        count = count.detach()
        if mesh.dp > 1:
            dist.all_reduce(count, group=mesh.dp_group)
        count = torch.clamp(count, min=1.0)
        loss = total / count
        loss.backward()
        loss = loss.detach()
        if mesh.dp > 1:
            grads: List[torch.Tensor] = [
                p.grad for p in state.params.parameters()]
            for g in grads:
                dist.all_reduce(g, group=mesh.dp_group)
            dist.all_reduce(loss, group=mesh.dp_group)
        state.optimizer.step()
        state.step += 1
        return state, float(loss)

    return init_fn, run_step

