"""What the small VAD networks share: a flat parameter tree and a recurrent
layer run in one call.

The JAX package keeps each small VAD network's weights as a flat dict of
named arrays (``lstm_wi``, ``enc0_w``, ...) saved with ``np.savez``. The
port's modules keep those names as parameters, except for the recurrent
layer, which is a ``torch.nn.LSTM`` or ``torch.nn.GRU`` (one call over
every frame, cuDNN on the card) whose weights map to the tree's leaves
by :data:`LSTM_LEAVES` / the GRU's own mapping in ``silero_like``.
:func:`run_rnn` runs it over a clip of any length: cuDNN refuses very
long sequences (an hour of Silero chunks is 112,500 steps), so the
frames go through in pieces of at most :data:`RNN_PIECE` steps with the
state carried from one piece to the next, which is the same recurrence.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# steps of one recurrent-layer call (cuDNN rejects 112,500 at batch 1)
RNN_PIECE = 16384
# torch.nn.LSTM parameter -> the JAX tree's leaf (torch LSTMCell layout:
# (4h, in) / (4h, h), gate order i, f, g, o)
LSTM_LEAVES = {"weight_ih_l0": "lstm_wi", "weight_hh_l0": "lstm_wh",
               "bias_ih_l0": "lstm_bi", "bias_hh_l0": "lstm_bh"}


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frozen(x, device) -> nn.Parameter:
    """An f32 parameter on ``device`` without gradient."""
    t = torch.as_tensor(np.array(as_numpy(x), np.float32, copy=True))
    return nn.Parameter(t.to(device), requires_grad=False)


def rnn_with(cls, n_in: int, hidden: int, weights: Mapping, device):
    """A one-layer batch-first ``cls`` (``nn.LSTM`` or ``nn.GRU``) on
    ``device`` holding ``weights`` (torch parameter name -> array). It is
    built on the meta device first, so nothing is drawn from the global
    RNG for weights replaced here."""
    rnn = cls(n_in, hidden, batch_first=True, device="meta")
    rnn = rnn.to_empty(device=device)
    for name, value in weights.items():
        getattr(rnn, name).data.copy_(frozen(value, device))
    rnn.requires_grad_(False)
    rnn.flatten_parameters()
    return rnn


def lstm_from_tree(tree: Mapping, hidden: int, device) -> nn.LSTM:
    """A one-layer batch-first ``nn.LSTM`` holding the tree's LSTM leaves."""
    return rnn_with(nn.LSTM, as_numpy(tree["lstm_wi"]).shape[1], hidden,
                    {name: tree[leaf] for name, leaf in LSTM_LEAVES.items()},
                    device)


def run_rnn(rnn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Hidden states (B, F, H) of a batch-first recurrent layer over x
    (B, F, in), zero initial state, in pieces of RNN_PIECE steps."""
    outs, state = [], None
    for i in range(0, x.shape[1], RNN_PIECE):
        out, state = rnn(x[:, i:i + RNN_PIECE].contiguous(), state)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_npz(path: str, tree: Mapping) -> None:
    np.savez(path, **{k: as_numpy(v) for k, v in tree.items()})
