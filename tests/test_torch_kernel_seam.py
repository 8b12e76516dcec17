"""The seam between the kernel wrappers and the built library
(``ops/cuda/_build.py``): each wrapper declares its own C entries and
goes through one device rule, on the CPU, with no card and no build."""

import re
from pathlib import Path

import pytest
import torch

from whisperjav_tpu_torch.models.layers import Int8
from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda import decode_attention as da
from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
from whisperjav_tpu_torch.ops.cuda import qwen_attention as qa
from whisperjav_tpu_torch.ops.cuda.encoder_attention import encoder_attention

PKG = Path(_build.__file__).resolve().parents[2]
L, B, R, D, H, T = 2, 2, 2, 128, 2, 8


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def _int8(k, n):
    return Int8(_t(L, k, n, dtype=torch.int8), _t(L, 1, n))


def _encoder():
    q = _t(B, T, H, 64, device="meta")
    return encoder_attention, (q, _t(B, T, H, 64), _t(B, T, H, 64))


def _kernel_b(wrapper, scaled):
    q = _t(B, R, H, 64, device="meta")
    kv = (_t(L, B, H, 64, T, dtype=torch.int8),) * 2
    tail = (_t(L, B, H),) if scaled else ()
    return wrapper, (q, *kv, 0, *tail)


def _self_block():
    x = _t(R, D, dtype=torch.bfloat16, device="meta")
    ln = _t(L, D, dtype=torch.bfloat16)
    cache = _t(L, R, T, D, dtype=torch.bfloat16)
    return fd.self_block, (x, ln, ln, _int8(D, 3 * D),
                           _t(L, 3 * D, dtype=torch.bfloat16),
                           _int8(D, D), ln, cache, cache, 0, 3, H)


def _cross_block():
    x = _t(R, D, dtype=torch.bfloat16, device="meta")
    ln = _t(L, D, dtype=torch.bfloat16)
    kv = _t(L, B, D, T, dtype=torch.int8)
    return fd.cross_block, (x, ln, ln, _int8(D, D), ln, _int8(D, D), ln,
                            kv, kv, _t(L, B, H), _t(L, B, H), 0, H)


def _mlp_block():
    x = _t(R, D, dtype=torch.bfloat16, device="meta")
    ln = _t(L, D, dtype=torch.bfloat16)
    return fd.mlp_block, (x, ln, ln, _int8(D, 4 * D),
                          _t(L, 4 * D, dtype=torch.bfloat16),
                          _int8(4 * D, D), ln, 0)


def _column():
    q = _t(B, 1, 4, 32)
    cache = _t(L, B, T, 64, device="meta")
    return qa.column_attention, (q, cache, cache, 0, 3, _t(B, 64),
                                 _t(B, 64))


@pytest.mark.parametrize("case", [
    _encoder,
    lambda: _kernel_b(da.decode_cross_attention, False),
    lambda: _kernel_b(da.decode_cross_attention_bf16, True),
    lambda: _kernel_b(da.decode_cross_attention_terms, True),
    _self_block, _cross_block, _mlp_block, _column,
], ids=["encoder_attention", "decode_cross_attention",
        "decode_cross_attention_bf16", "decode_cross_attention_terms",
        "self_block", "cross_block", "mlp_block", "column_attention"])
def test_wrapper_refuses_operands_on_two_devices(case):
    """CPU and ``meta`` operands together neither run the plain version
    nor reach a kernel: the wrapper raises, naming itself."""
    wrapper, args = case()
    before = wrapper.launches
    with pytest.raises(ValueError,
                       match=rf"^{wrapper.__name__}: .*one CUDA device"):
        wrapper(*args)
    assert wrapper.launches == before


def test_each_kernel_entry_is_declared_by_one_wrapper():
    """Every ``extern "C"`` entry of ``csrc/`` is declared (``_build.entry``)
    in exactly one module of the package; ``_build.py`` names no entry
    but the library-wide ``wjt_error_string`` and guards none."""
    csrc = "\n".join(p.read_text() for p in (PKG / "csrc").glob("*.cu"))
    defined = set(re.findall(r'extern "C"[^(]*?\b(wjt_\w+)\s*\(', csrc))
    assert "wjt_error_string" in defined and len(defined) > 5
    declared = {}
    for path in sorted(PKG.rglob("*.py")):
        for name in re.findall(r'_build\.entry\(\s*"(wjt_\w+)"',
                               path.read_text()):
            declared.setdefault(name, []).append(path.name)
    assert {n: len(mods) for n, mods in declared.items()} \
        == dict.fromkeys(defined - {"wjt_error_string"}, 1), declared
    build_src = Path(_build.__file__).read_text()
    assert set(re.findall(r"\bwjt_\w+", build_src)) == {"wjt_error_string"}
    assert "hasattr" not in build_src
    for module in (da, fd, qa):
        for value in vars(module).values():
            if isinstance(value, _build.entry):
                assert value.name in defined
