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
with the finite ``NEG_INF`` and ``l`` floored at ``1e-30``. The bf16 K1-K3
run every product on the tensor cores (``mma.sync``: bf16 operands, f32
sums, the same casts); the f32 K1-K3 too, in split TF32 (each operand
hi + lo in TF32, three products summed in f32: close to f32 accuracy).
p and ds stay in registers in every kernel. Any head dim ``>= 1`` runs
(the JAX kernels pad any to a multiple of 128 lanes): up to 128 the tiles
hold whole rows of dh; past 128 the wide kernels take over
(:func:`wide_tiling`): each keeps the block's own rows in shared memory
(K1: 128 q rows a block, :data:`WIDE_FORWARD_ROWS`), computes the scores
once per tile pair and keeps all of dh's output sums in registers up to dh
256 (bf16 on ``wgmma`` fed by TMA, f32 in split TF32), and past 256 makes
the outputs in chunks of 256 columns. A block's shared memory and
registers stay bounded at every head dim.

On a CPU tensor every wrapper computes its plain version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`) —
non-blocked torch with the same masks and casts, the CPU tests' anchor
against the JAX kernels, and ``chip_smoke.py``'s against the CUDA ones. A
CUDA tensor launches the kernel or raises: nothing falls back. Each wrapper
counts its launches (``flash_forward.launches``, ``flash_dq.launches``,
``flash_dkv.launches``).

Inside a program trace (``analysis/trace.py``) the tensors are fake: each
wrapper then calls its ``torch.library`` custom op (``sdml::flash_forward``,
``sdml::flash_dq``, ``sdml::flash_dkv``), whose fake implementation gives
the outputs' shapes — one graph node per launch, nothing run — and notes
its :func:`launch_spec` for the kernel linter. On real tensors each op is
its wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    kernels as _kernels,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    trace as _trace,
)
from simple_distributed_machine_learning_tpu_torch.ops.attention import (
    _merge_heads,
    _split_heads,
)

NEG_INF = -1e30
#: the widest head dim the whole-row kernels take; wider ones run the wide
#: kernels (``csrc/flash_attention.cu``, the wide kernels' section)
WHOLE_ROW_HEAD_DIM = 128
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
    if _trace.is_fake(q):
        _kernels.note(lambda: launch_spec("flash_forward", q))
        return torch.ops.sdml.flash_forward(q, k, v)
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
    if _trace.is_fake(q):
        _kernels.note(lambda: launch_spec("flash_dq", q))
        return torch.ops.sdml.flash_dq(q, k, v, do, m, linv, delta)
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
    if _trace.is_fake(q):
        _kernels.note(lambda: launch_spec("flash_dkv", q))
        return torch.ops.sdml.flash_dkv(q, k, v, do, m, linv, delta)
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


# -- the kernels as graph nodes (program traces) ---------------------------------

@torch.library.custom_op("sdml::flash_forward", mutates_args=())
def _flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as a graph node: on real tensors the wrapper."""
    return flash_forward(q, k, v)


@_flash_forward_op.register_fake
def _(q, k, v):
    rows = q.new_empty(tuple(q.shape[:3]), dtype=torch.float32)
    return torch.empty_like(q), rows, torch.empty_like(rows)


@torch.library.custom_op("sdml::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, m: torch.Tensor, linv: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """K2 as a graph node: on real tensors the wrapper."""
    return flash_dq(q, k, v, do, m, linv, delta)


@_flash_dq_op.register_fake
def _(q, k, v, do, m, linv, delta):
    return torch.empty_like(q)


@torch.library.custom_op("sdml::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, m: torch.Tensor, linv: torch.Tensor,
                  delta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 as a graph node: on real tensors the wrapper."""
    return flash_dkv(q, k, v, do, m, linv, delta)


@_flash_dkv_op.register_fake
def _(q, k, v, do, m, linv, delta):
    return torch.empty_like(k), torch.empty_like(v)


#: rows and keys per tile of the CUDA kernels (``csrc/flash_attention.cu``
#: ``kTile``): a grid cell's block of q (K1, K2) or k/v (K3) rows
TILE = 64


#: the head dim up to which the wide kernels keep the block's own rows
#: whole in shared memory and make all of dh's outputs at once
#: (``csrc/flash_attention.cu``, the wide kernels)
RESIDENT_HEAD_DIM = 256

#: q rows a block of the wide K1 owns (``kFwdRows``): two tiles, each k/v
#: tile serving both; K2 and K3 own one tile of :data:`TILE` rows
WIDE_FORWARD_ROWS = 2 * TILE


def wide_tiling(kernel: str, dh: int, dtype: torch.dtype):
    """``(slice, chunk)`` columns of the wide kernels (dh > 128,
    ``csrc/flash_attention.cu``), or None at dh <= 128: the contraction
    over dh is read in slices of ``slice`` columns, and the outputs are
    made in chunks of ``chunk`` columns.

    K1, K2 and K3 alike: up to dh 256 the outputs in one chunk of dh
    columns, the other side's tiles read in slices of dh (bf16: each tile
    whole, once) or 64 (f32); past 256, chunks of 256 columns, the
    contraction in slices of 128 (bf16) or 64 (f32), the own rows streamed
    beside the other side's."""
    if dh <= WHOLE_ROW_HEAD_DIM:
        return None
    chunk = dh if dh <= RESIDENT_HEAD_DIM else 256
    if dtype.itemsize == 4:
        return 64, chunk
    return (dh if dh <= RESIDENT_HEAD_DIM else 128), chunk


def launch_spec(kernel: str, q: torch.Tensor):
    """The :class:`~..analysis.kernels.LaunchSpec` of one launch of K1
    (``"flash_forward"``), K2 (``"flash_dq"``) or K3 (``"flash_dkv"``) on
    q/k/v ``[B, H, T, dh]`` (shapes and dtypes only), over the kernels'
    contiguous ``[B*H, T, dh]`` rows.

    Grid ``(B*H, ceil(T/64))``, both parallel; inside each block a loop
    over the other side's 64-row tiles (arbitrary: the causal kernels stop
    at the diagonal, so this is the most they read). K1 and K2: the cell
    owns q tile ``i`` (q, do and the row statistics at ``(bh, i)``), the
    loop reads k/v tile ``kb``; K3: the cell owns k/v tile ``j`` and the
    loop reads q, do and the statistics of tile ``qb``. The running sums
    are f32.

    At dh > 128 (:func:`wide_tiling`) the blocks are the wide kernels':
    the loop is ``(chunk c, tile, slice s)``, the scores' operands are read
    at slice ``s`` (the cell's own as ``(1, rows, slice)`` blocks, the
    other side's tiles as ``(1, 64, slice)``), the operand of the chunk's
    product (v in K1, k in K2, do and q in K3) as ``(1, 64, chunk)`` at
    ``c``, and each output as ``(1, rows, chunk)`` at ``c`` (l and m whole
    rows, once). Up to dh
    256 the cell's own rows (K1 q; K2 q, do; K3 k, v) are one ``(1, rows,
    dh)`` block, read once and kept. A K1 cell owns
    :data:`WIDE_FORWARD_ROWS` q rows (grid ``(B*H, ceil(T/128))``), a K2 or
    K3 cell 64."""
    from simple_distributed_machine_learning_tpu_torch.analysis.kernels import (  # noqa: E501
        LaunchSpec,
        Operand,
    )
    B, H, T, dh = q.shape
    wide = wide_tiling(kernel, dh, q.dtype)
    if wide is not None:
        return _wide_launch_spec(kernel, q, wide)
    BH, n = B * H, -(-T // TILE)
    rows = (BH, T, dh)
    blk = (1, TILE, dh)
    stat, sblk = (BH, T), (1, TILE)

    def own(bh, i, kb):
        return (bh, i, 0)

    def other(bh, i, kb):
        return (bh, kb, 0)

    def own_stat(bh, i, kb):
        return (bh, i)

    def other_stat(bh, i, kb):
        return (bh, kb)

    def op(name, shape, block, dtype, at, output=False):
        return Operand(name, shape, block, dtype, at, output=output)

    f32 = torch.float32
    if kernel == "flash_forward":
        ops = (op("q", rows, blk, q.dtype, own),
               op("k", rows, blk, q.dtype, other),
               op("v", rows, blk, q.dtype, other),
               op("o", rows, blk, q.dtype, own, True),
               op("l", stat, sblk, f32, own_stat, True),
               op("m", stat, sblk, f32, own_stat, True))
    elif kernel == "flash_dq":
        ops = (op("q", rows, blk, q.dtype, own),
               op("do", rows, blk, q.dtype, own),
               op("m", stat, sblk, f32, own_stat),
               op("linv", stat, sblk, f32, own_stat),
               op("delta", stat, sblk, f32, own_stat),
               op("k", rows, blk, q.dtype, other),
               op("v", rows, blk, q.dtype, other),
               op("dq", rows, blk, q.dtype, own, True))
    elif kernel == "flash_dkv":
        ops = (op("k", rows, blk, q.dtype, own),
               op("v", rows, blk, q.dtype, own),
               op("q", rows, blk, q.dtype, other),
               op("do", rows, blk, q.dtype, other),
               op("m", stat, sblk, f32, other_stat),
               op("linv", stat, sblk, f32, other_stat),
               op("delta", stat, sblk, f32, other_stat),
               op("dk", rows, blk, q.dtype, own, True),
               op("dv", rows, blk, q.dtype, own, True))
    else:
        raise ValueError(f"no flash kernel {kernel!r}")
    return LaunchSpec(kernel=kernel,
                      where=f"{__name__}.{kernel} (ops/csrc/flash_attention.cu)",
                      grid=(BH, n), loop=(n,), operands=ops,
                      scratch=(torch.float32,))


def _wide_launch_spec(kernel: str, q: torch.Tensor, wide):
    """:func:`launch_spec` at dh > 128: grid ``(B*H, ceil(T/rows))`` (K1
    128 rows a cell, K2 and K3 64), loop ``(chunks, k/v or q tiles,
    slices)`` over 64-row tiles."""
    from simple_distributed_machine_learning_tpu_torch.analysis.kernels import (  # noqa: E501
        LaunchSpec,
        Operand,
    )
    B, H, T, dh = q.shape
    cell = WIDE_FORWARD_ROWS if kernel == "flash_forward" else TILE
    BH, n, n_cells = B * H, -(-T // TILE), -(-T // cell)
    ds, dc = wide
    n_s, n_c = -(-dh // ds), -(-dh // dc)
    rows, stat = (BH, T, dh), (BH, T)
    sl, ck = (1, TILE, ds), (1, TILE, dc)
    own_sl, own_ck, sblk = (1, cell, ds), (1, cell, dc), (1, cell)
    f32, dt = torch.float32, q.dtype

    # index maps over (bh, i, c, kb, s): i the cell's rows, kb the loop's
    # tile
    def other_s(bh, i, c, kb, s):
        return (bh, kb, s)

    def own_c(bh, i, c, kb, s):
        return (bh, i, c)

    def other_c(bh, i, c, kb, s):
        return (bh, kb, c)

    def own_stat(bh, i, c, kb, s):
        return (bh, i)

    def other_stat(bh, i, c, kb, s):
        return (bh, kb)

    # the cell's own rows: one whole block, kept, up to dh 256
    resident = dh <= RESIDENT_HEAD_DIM
    own_blk = (1, cell, dh) if resident else own_sl

    def own_r(bh, i, c, kb, s):
        return (bh, i, 0) if resident else (bh, i, s)

    if kernel == "flash_forward":
        ops = (Operand("q", rows, own_blk, dt, own_r),
               Operand("k", rows, sl, dt, other_s),
               Operand("v", rows, ck, dt, other_c),
               Operand("o", rows, own_ck, dt, own_c, output=True),
               Operand("l", stat, sblk, f32, own_stat, output=True),
               Operand("m", stat, sblk, f32, own_stat, output=True))
    elif kernel == "flash_dq":
        ops = (Operand("q", rows, own_blk, dt, own_r),
               Operand("do", rows, own_blk, dt, own_r),
               Operand("m", stat, sblk, f32, own_stat),
               Operand("linv", stat, sblk, f32, own_stat),
               Operand("delta", stat, sblk, f32, own_stat),
               Operand("k", rows, sl, dt, other_s),
               Operand("v", rows, sl, dt, other_s),
               Operand("k_chunk", rows, ck, dt, other_c),
               Operand("dq", rows, own_ck, dt, own_c, output=True))
    elif kernel == "flash_dkv":
        ops = (Operand("k", rows, own_blk, dt, own_r),
               Operand("v", rows, own_blk, dt, own_r),
               Operand("q", rows, sl, dt, other_s),
               Operand("do", rows, sl, dt, other_s),
               Operand("do_chunk", rows, ck, dt, other_c),
               Operand("q_chunk", rows, ck, dt, other_c),
               Operand("m", stat, sblk, f32, other_stat),
               Operand("linv", stat, sblk, f32, other_stat),
               Operand("delta", stat, sblk, f32, other_stat),
               Operand("dk", rows, own_ck, dt, own_c, output=True),
               Operand("dv", rows, own_ck, dt, own_c, output=True))
    else:
        raise ValueError(f"no flash kernel {kernel!r}")
    return LaunchSpec(kernel=kernel,
                      where=f"{__name__}.{kernel} (ops/csrc/flash_attention.cu)",
                      grid=(BH, n_cells), loop=(n_c, n, n_s), operands=ops,
                      scratch=(torch.float32,))


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
        if q.device.type == "cpu" and not _trace.is_fake(q):
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
