"""whisperjav-tpu on PyTorch and CUDA (NVIDIA Hopper).

A port of ``whisperjav_tpu`` that runs the flagless ``whisperjav <file>``
path (balanced mode and sensitivity: turbo, beam 2, int8 cross-K/V, bf16)
on one GPU. The JAX package is the reference it is tested against; the
jax-free host modules of that package (scene detection, VAD, media, SRT,
sanitizer, presets, tokenizer) are used by import. The port never
imports jax.

Entry point: ``whisperjav-torch`` (:mod:`whisperjav_tpu_torch.cli`).
Hand-written kernels: ``csrc/*.cu``, built at first use by
:mod:`whisperjav_tpu_torch.ops.cuda._build`.
"""
