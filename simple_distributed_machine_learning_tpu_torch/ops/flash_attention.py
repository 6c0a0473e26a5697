"""Causal flash attention: the training path's attention kernels.

Port of ``ops/flash_attention.py``. ``attn_impl="flash"`` blocks
(``models/gpt.py::_block_train``) call :func:`flash_attention`, a
``torch.autograd.Function`` whose forward runs K1 and whose backward runs
K2 and K3 — the CUDA kernels of ``csrc/flash_attention.cu``, which replace
the Pallas TPU kernels ``_flash_kernel`` (K1), ``_dq_kernel`` (K2) and
``_dkv_kernel`` (K3):

- :func:`flash_forward` (K1): ``(o, l, m)``: causal softmax(q·kᵀ/√dh)·v
  by online softmax over k tiles up to the diagonal; ``l`` (the
  unnormalised row sum) and ``m`` (the row max) are saved in f32;
- :func:`flash_dq` (K2): ``dq = Σ_k ds·k·scale``;
- :func:`flash_dkv` (K3): ``dv = Σ_q pᵀ·do``, ``dk = Σ_q dsᵀ·q·scale``;

where ``p = exp(s − m)·linv`` is recomputed from the saved statistics,
``ds = p·(do·vᵀ − delta)``, and ``linv = 1/max(l, 1e-30)`` and ``delta =
rowsum(do·o)`` are plain torch here, as they are plain ``jnp`` in the JAX
package's ``_flash_bwd``. The backward is the JAX design's two passes: no
atomics, deterministic.

Casts mirror the TPU kernels': products take their operands in the input
dtype (f32 or bf16) and sum in f32; ``p`` is rounded to v's dtype before
p·v, and ``ds·scale`` to k's (q's) dtype before the dq (dk) product. Masks:
``qpos >= kpos & kpos < T`` in the forward, ``& qpos < T`` in the backward,
with the finite ``NEG_INF`` and ``l`` floored at ``1e-30``. The f32 K1-K3
compute on the CUDA cores in f32; the bf16 K1-K3 run every product on the
tensor cores (``mma.sync``: bf16 operands, f32 sums, the same casts), with
p and ds kept in registers.

On a CPU tensor every wrapper computes its plain version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`) —
non-blocked torch with the same masks and casts, the CPU tests' anchor
against the JAX kernels, and ``chip_smoke.py``'s against the CUDA ones. A
CUDA tensor launches the kernel or raises: nothing falls back. Each wrapper
counts its launches (``flash_forward.launches``, ``flash_dq.launches``,
``flash_dkv.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.ops.attention import (
    _merge_heads,
    _split_heads,
)

NEG_INF = -1e30
MAX_HEAD_DIM = 128
#: dtypes the kernels are instantiated for -> their dtype code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use only) and bind ``csrc/flash_attention.cu``."""
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (
        build,
    )
    built = build("sdml_flash_attention", ["flash_attention.cu"])
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdml_flash_forward.argtypes = [p] * 6 + [i, i, i, f, i, p]
    lib.sdml_flash_dq.argtypes = [p] * 8 + [i, i, i, f, i, p]
    lib.sdml_flash_dkv.argtypes = [p] * 9 + [i, i, i, f, i, p]
    for fn in (lib.sdml_flash_forward, lib.sdml_flash_dq, lib.sdml_flash_dkv):
        fn.restype = ctypes.c_int
    lib.sdml_flash_error_string.argtypes = [ctypes.c_int]
    lib.sdml_flash_error_string.restype = ctypes.c_char_p
    return built


def build_kernel():
    """Build and load the kernel library now (``chip_smoke.py`` times the
    build); returns the ``BuiltLibrary`` record."""
    return _library()


# -- the plain versions --------------------------------------------------------

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 sums for f32/bf16 inputs (the kernels'); f64 stays f64, so
    ``torch.autograd.gradcheck`` can run the plain versions."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q: torch.Tensor, k: torch.Tensor):
    """Unmasked ``q·kᵀ·scale`` in the sum dtype, and the causal mask."""
    acc = _acc_dtype(q.dtype)
    t, dh = q.shape[2], q.shape[3]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (
        1.0 / math.sqrt(dh))
    pos = torch.arange(t, device=q.device)
    return s, pos[:, None] >= pos[None, :]


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor):
    """K1's plain version: ``(o, l, m)`` for q/k/v ``[B, H, T, dh]``, with
    one softmax over the whole row (the kernel's blocking changes only the
    order of f32 sums). ``o`` in the input dtype; ``l``, ``m`` ``[B, H, T]``
    in f32 (f64 for f64 inputs)."""
    acc = _acc_dtype(q.dtype)
    s, live = _scores(q, k)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    return o.to(q.dtype), l, m


def _backward_stats(o: torch.Tensor, l: torch.Tensor, do: torch.Tensor):
    """``(linv, delta)``: ``1/max(l, 1e-30)`` and ``rowsum(do·o)``."""
    acc = _acc_dtype(o.dtype)
    delta = (do.to(acc) * o.to(acc)).sum(-1)
    return 1.0 / torch.clamp_min(l.to(acc), 1e-30), delta


def _p_ds(q, k, v, do, m, linv, delta):
    """The backward's recomputed ``p = exp(s − m)·linv`` and ``ds·scale =
    p·(do·vᵀ − delta)·scale``, in the sum dtype."""
    acc = _acc_dtype(q.dtype)
    s, live = _scores(q, k)
    p = torch.where(live, torch.exp(s - m.to(acc)[..., None])
                    * linv.to(acc)[..., None], 0.0)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc)[..., None]) * (1.0 / math.sqrt(
        q.shape[3]))


def _dq_of(ds, q, k):
    acc = ds.dtype
    return torch.matmul(ds.to(k.dtype).to(acc), k.to(acc)).to(q.dtype)


def _dkv_of(p, ds, q, k, v, do):
    acc = ds.dtype
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), q.to(acc))
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_reference(q, k, v, do, m, linv, delta) -> torch.Tensor:
    """K2's plain version: ``dq`` (input dtype) from the row statistics."""
    return _dq_of(_p_ds(q, k, v, do, m, linv, delta)[1], q, k)


def flash_dkv_reference(q, k, v, do, m, linv, delta):
    """K3's plain version: ``(dk, dv)`` (input dtype)."""
    p, ds = _p_ds(q, k, v, do, m, linv, delta)
    return _dkv_of(p, ds, q, k, v, do)


def flash_backward_reference(q, k, v, o, l, m, do):
    """K2 + K3's plain version: ``(dq, dk, dv)`` from the forward's saved
    ``(q, k, v, o, l, m)`` and the cotangent ``do``."""
    linv, delta = _backward_stats(o, l, do)
    p, ds = _p_ds(q, k, v, do, m, linv, delta)
    return (_dq_of(ds, q, k), *_dkv_of(p, ds, q, k, v, do))


# -- the kernel wrappers -------------------------------------------------------

def _check_qkv(q, k, v, dev: torch.device) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must all be [B, H, T, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[2] < 1:
        raise ValueError("flash attention needs T >= 1")
    for t in (q, k, v):
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"flash attention: a tensor lies on {t.device}, "
                             f"expected {dev}")


def _check_kernel_inputs(q: torch.Tensor) -> None:
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_HEAD_DIM}: the "
                         f"kernels keep 64-row tiles of dh floats in shared "
                         f"memory")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().lib.sdml_flash_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")


def _dims(q: torch.Tensor):
    B, H, T, dh = q.shape
    return B * H, T, dh, 1.0 / math.sqrt(dh), _KERNEL_DTYPES[q.dtype]


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K1: ``(o, l, m)`` for q/k/v ``[B, H, T, dh]``. CUDA launches the
    kernel (counted in ``flash_forward.launches``); the CPU computes
    :func:`flash_forward_reference`."""
    _check_qkv(q, k, v, q.device)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v)
    _check_kernel_inputs(q)
    # the kernel indexes contiguous [B*H, T, dh] rows
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    BH, T, dh, scale, code = _dims(q)
    o = torch.empty_like(q)
    l = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_library().lib.sdml_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(),
        m.data_ptr(), BH, T, dh, scale, code, stream), "flash_forward")
    flash_forward.launches += 1
    return o, l, m


flash_forward.launches = 0


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    for r in rows:
        if tuple(r.shape) != tuple(q.shape[:3]) or r.device != q.device:
            raise ValueError(f"row statistics must be {tuple(q.shape[:3])} "
                             f"on {q.device}, got {tuple(r.shape)} on "
                             f"{r.device}")


def _bwd_operands(q, k, v, do, m, linv, delta):
    _check_kernel_inputs(q)
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    rows = [r.to(torch.float32).contiguous() for r in (m, linv, delta)]
    return ([t.contiguous() for t in (q, k, v, do.to(q.dtype))], rows)


def flash_dq(q, k, v, do, m, linv, delta) -> torch.Tensor:
    """K2: ``dq`` from ``do`` and the row statistics ``m``, ``linv``,
    ``delta`` ``[B, H, T]``. CUDA launches the kernel (counted in
    ``flash_dq.launches``); the CPU computes the plain version."""
    _check_qkv(q, k, v, q.device)
    _check_rows(q, m, linv, delta)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, m, linv, delta)
    (q, k, v, do), (m, linv, delta) = _bwd_operands(q, k, v, do, m, linv,
                                                    delta)
    BH, T, dh, scale, code = _dims(q)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_library().lib.sdml_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), linv.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        BH, T, dh, scale, code, stream), "flash_dq")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, m, linv, delta):
    """K3: ``(dk, dv)``, as :func:`flash_dq`. CUDA launches the kernel
    (counted in ``flash_dkv.launches``); the CPU computes the plain
    version."""
    _check_qkv(q, k, v, q.device)
    _check_rows(q, m, linv, delta)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, m, linv, delta)
    (q, k, v, do), (m, linv, delta) = _bwd_operands(q, k, v, do, m, linv,
                                                    delta)
    BH, T, dh, scale, code = _dims(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(_library().lib.sdml_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), linv.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), BH, T, dh, scale, code, stream), "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward, saving ``(q, k, v, o, l, m)`` — the
    JAX ``custom_vjp``'s residuals. On CPU tensors the plain versions run
    in both directions, so the CPU tests exercise the saved-statistics
    contract, not autograd through the plain forward."""

    @staticmethod
    def forward(ctx, q, k, v):
        # contiguous once, so the backward's kernels copy nothing again
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, l, m = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, l, m)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            return flash_backward_reference(q, k, v, o, l, m, do)
        linv, delta = _backward_stats(o, l, do)
        dq = flash_dq(q, k, v, do, m, linv, delta)
        dk, dv = flash_dkv(q, k, v, do, m, linv, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 128, block_k: int = 128,
                    device=None) -> torch.Tensor:
    """Causal flash attention, differentiable: q/k/v ``[B, H, T, dh]`` ->
    ``[B, H, T, dh]``, equal to the dense ``causal_attention_core`` to
    float tolerance.

    ``block_q``/``block_k`` are the JAX signature's TPU block sizes
    (``GPTConfig.flash_block_q/k``): validated and otherwise unused — the
    CUDA kernels tile by 64 x 64 for shared memory, and a blocking changes
    only the order of f32 sums. ``device`` (None = ``"cuda"``) is where the
    call must run: the tensors must lie there."""
    dev = resolve_device(device)
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"flash blocks must be positive, got "
                         f"{block_q}/{block_k}")
    _check_qkv(q, k, v, dev)
    return _FlashAttention.apply(q, k, v)


def flash_mha(params, x: torch.Tensor, n_heads: int, block_q: int = 128,
              block_k: int = 128, device=None) -> torch.Tensor:
    """Drop-in for ``causal_attention`` through the flash kernels: x
    ``[B, T, D]`` -> ``[B, T, D]`` with the same QKVO params
    (``attention.mha_init``)."""
    q = _split_heads(x @ params["wq"], n_heads)
    k = _split_heads(x @ params["wk"], n_heads)
    v = _split_heads(x @ params["wv"], n_heads)
    o = flash_attention(q, k, v, block_q, block_k, device=device)
    return _merge_heads(o) @ params["wo"]
