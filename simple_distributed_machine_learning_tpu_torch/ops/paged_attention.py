"""Paged attention: block-table gather + masked attention in one kernel pass.

Port of ``ops/paged_attention.py``. The serving decode tick
(``models/gpt.py::_paged_decode_fwd`` with ``kernel="fused"``, one query
per slot) and the speculative verify step (``_paged_verify_fwd``,
``spec_k`` queries per slot) call :func:`paged_attention` once per layer.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``_paged_attn_kernel``: per (slot, head, group of at most 8 queries —
:func:`query_groups`) it reads each K/V row up to the group's newest query
position once, dequantising int8/fp8 rows with their per-row f32 scales,
folds the position-masked f32 scores into online softmaxes, and merges
them once at the end — no gathered copy and no score matrix ever reaches
device memory. Two designs (the source's header has both): up to head dim
128 (:data:`NARROW_HEAD_DIM`) one block's warps split the slot's table and
hold the rows in registers; past it :func:`key_parts` blocks of a
thread-block cluster split the slot's live blocks (:func:`part_blocks`),
stream whole slabs through shared memory and merge through distributed
shared memory. The tick is bound by those K/V bytes, and at serving sizes
by how many of their loads are in flight.

On a CPU tensor the wrapper computes :func:`paged_attention_reference`,
the plain version (gather rows, mask, softmax, einsum in f32) — the CPU
tests compare it with the JAX kernel, and ``chip_smoke.py`` compares it
with the CUDA kernel on the card. A CUDA tensor never falls back to it:
the wrapper launches the kernel or raises.

:func:`launch_spec` declares what one launch reads and writes, for the
kernel linter (``analysis/kernels.py``); inside
``kernels.record_launches()`` the wrapper appends it to the log on both
paths (through ``kernels.note``).

Inside a program trace (``analysis/trace.py``) the arguments are fake
tensors: the wrapper then calls the ``torch.library`` custom op
``sdml::paged_attention``, whose fake implementation gives the output's
shape, so the launch is one graph node and nothing runs. On real tensors
that op is the wrapper itself (the plain version on the CPU, the kernel
on CUDA); the wrapper calls the kernel directly, past the dispatcher.

Masks: the kernel masks with the finite ``NEG_INF`` and floors the
softmax denominator at ``1e-30`` like the TPU kernel; the plain version
masks with ``-inf`` like the dense serving path. Position 0 is always
live, so the two agree on every slot, trash-routed ones included.
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

NEG_INF = -1e30

#: storage dtypes the kernel is instantiated for -> its dtype code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                  torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_QUANTIZED = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)
#: queries one block of the kernel takes: each lane holds its output
#: columns for every query of its block in registers
QUERIES_PER_GROUP = 8
#: head dims the register-resident kernel takes; past it the wide one
NARROW_HEAD_DIM = 128
#: blocks a wide launch splits each (slot, head, query group) over at most:
#: one thread-block cluster, whose portable size is 8
MAX_KEY_PARTS = 8
#: blocks a wide launch aims to give one slot: about the card's 132 SMs
_SLOT_BLOCKS = 128


@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use only) and bind ``csrc/paged_attention.cu``."""
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (
        build,
    )
    built = build("sdml_paged_attention", ["paged_attention.cu"])
    fn = built.lib.sdml_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    built.lib.sdml_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.sdml_cuda_error_string.restype = ctypes.c_char_p
    return built


def key_parts(dh: int, H: int, NB: int) -> int:
    """Blocks (one thread-block cluster) each (slot, head, query group)
    splits its table over: 1 up to :data:`NARROW_HEAD_DIM`; past it the
    least power of two up to :data:`MAX_KEY_PARTS` that gives a slot's
    ``H`` heads about the card's SMs, halved until it divides the table
    width ``NB`` (so the launch spec's static cut bills each block once).
    Fixed by the launch's shapes alone: never by the slot count or the
    slots' positions, so a slot's arithmetic is the same alone or in a
    batch."""
    if int(dh) <= NARROW_HEAD_DIM:
        return 1
    p = 1
    while p < MAX_KEY_PARTS and int(H) * p < _SLOT_BLOCKS:
        p *= 2
    while int(NB) % p:
        p //= 2
    return p


def part_blocks(n_kb: int, parts: int, p: int) -> tuple[int, int]:
    """The logical blocks ``[lo, hi)`` part ``p`` of ``parts`` takes of a
    slot's ``n_kb`` live ones (``min(last // bs + 1, NB)``, ``last`` the
    group's newest position), as the wide kernel cuts them: consecutive,
    in order, sizes within one of each other; empty where ``n_kb <
    parts``."""
    return n_kb * p // parts, n_kb * (p + 1) // parts


def query_groups(K: int) -> int:
    """Blocks per (slot, head) one launch runs for ``K`` queries per slot:
    ``ceil(K / 8)`` groups of consecutive queries, each reading the slot's
    K/V rows up to its own newest position."""
    return -(-int(K) // QUERIES_PER_GROUP)


def build_kernel():
    """Build and load the kernel library now (``chip_smoke.py`` times the
    build); returns the ``BuiltLibrary`` record."""
    return _library()


def take_blocks(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cache[idx]`` along the physical-block axis. One-byte storage
    (int8, fp8) indexes through a ``uint8`` view, which every backend
    supports for every such dtype."""
    if cache.element_size() == 1:
        return cache.view(torch.uint8)[idx].view(cache.dtype)
    return cache[idx]


def gather_paged_rows(cache_l: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """One layer's blocks ``[n_blocks, H, bs, ...]`` gathered through a
    block table ``[NB]`` or ``[S, NB]`` into sequence order
    ``[..., H, NB*bs, ...]``: position ``p`` lands at row ``p``."""
    rows = take_blocks(cache_l, table.long())      # [..., NB, H, bs, (dh)]
    nb_axis = table.dim() - 1
    rows = rows.movedim(nb_axis, nb_axis + 1)      # [..., H, NB, bs, (dh)]
    shape = rows.shape
    return rows.reshape(*shape[:nb_axis + 1], shape[nb_axis + 1]
                        * shape[nb_axis + 2], *shape[nb_axis + 3:])


def paged_attention_reference(q, kc, vc, tables, qpos, *, block_size: int,
                              kscale=None, vscale=None) -> torch.Tensor:
    """The plain torch version of the kernel: gather every slot's table
    span, dequantise, mask ``kpos <= qpos``, softmax, einsum — in f32."""
    S, H, K, dh = q.shape
    span = tables.shape[1] * block_size
    krow = gather_paged_rows(kc, tables).float()   # [S, H, span, dh]
    vrow = gather_paged_rows(vc, tables).float()
    if kscale is not None:
        krow = krow * gather_paged_rows(kscale, tables)[..., None]
        vrow = vrow * gather_paged_rows(vscale, tables)[..., None]
    scores = torch.einsum("shqd,shkd->shqk", q.float(), krow) / math.sqrt(dh)
    kpos = torch.arange(span, device=q.device)
    live = (kpos[None, None, :] <= qpos.long()[:, :, None])[:, None]
    scores = torch.where(live, scores, -math.inf)
    return torch.einsum("shqk,shkd->shqd", torch.softmax(scores, dim=-1),
                        vrow)


def launch_spec(q, kc, vc, tables, qpos, *, block_size: int, kscale=None,
                vscale=None):
    """The :class:`~..analysis.kernels.LaunchSpec` of one launch on these
    arguments (only their shapes and dtypes are read). Up to
    :data:`NARROW_HEAD_DIM`: grid (S, H, ``query_groups(K)``), all
    parallel; inside each block a loop over the slot's logical blocks
    ``kb`` in ``[0, NB-1]`` (arbitrary: the kernel stops at the group's
    newest position, so this is the most it reads). K/V blocks ``(1, 1,
    bs, dh)`` (and the scale planes' ``(1, 1, bs)`` of a quantised pool)
    at ``(tables[s, kb], h, 0, 0)``; queries and output ``(1, 1, min(K,
    8), dh)`` at ``(s, h, g, 0)``. The online softmax state is f32. The
    tables carry no contract: the caller declares one
    (``LaunchSpec.with_contracts``).

    Past it the grid gains the :func:`key_parts` axis ``p`` (S, H,
    ``query_groups(K)``, P) and the loop runs ``NB // P`` blocks, part
    ``p`` taking ``kb = p * NB // P + i``: the P parts cover the table
    once, so each K/V block is billed once per query group (the kernel
    cuts each slot's live blocks the same way, :func:`part_blocks`). Each
    part reads the group's queries whole and writes output columns
    ``(1, 1, ·, ceil(dh / P))`` at its ``p``: the cluster's merge."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (  # noqa: E501
        spec,
    )
    S, H, K, dh = q.shape
    NB = tables.shape[1]
    bs = int(block_size)
    qg = min(K, QUERIES_PER_GROUP)
    wide = dh > NARROW_HEAD_DIM
    P = key_parts(dh, H, NB)
    per = NB // P
    cw = -(-dh // P)
    # the maps take (s, h, g[, p], kb or i, tbl, qp): p only past 128
    grid = (S, H, query_groups(K)) + ((P,) if wide else ())

    def at_query(s, h, g, *rest):
        return (s, h, g, 0)

    def at_out(s, h, g, *rest):
        return (s, h, g, rest[0] if wide else 0)

    def logical(rest):
        """The logical block a map's trailing axes (p, i or kb) name."""
        return rest[0] * per + rest[1] if wide else rest[0]

    def at_block(s, h, g, *rest):
        tbl = rest[-2]
        return (tbl[s, logical(rest)], h, 0, 0)

    def at_scale(s, h, g, *rest):
        tbl = rest[-2]
        return (tbl[s, logical(rest)], h, 0)

    ops = [_kernels.Operand("q", tuple(q.shape), (1, 1, qg, dh), q.dtype,
                            at_query),
           _kernels.Operand("k", tuple(kc.shape), (1, 1, bs, dh), kc.dtype,
                            at_block),
           _kernels.Operand("v", tuple(vc.shape), (1, 1, bs, dh), vc.dtype,
                            at_block)]
    if kscale is not None:
        ops += [_kernels.Operand(name, tuple(t.shape), (1, 1, bs), t.dtype,
                                 at_scale)
                for name, t in (("kscale", kscale), ("vscale", vscale))]
    ops.append(_kernels.Operand("out", (S, H, K, dh),
                                (1, 1, qg, cw if wide else dh),
                                torch.float32, at_out, output=True))
    return _kernels.LaunchSpec(
        kernel="paged_attention",
        where=f"{__name__}.paged_attention "
              f"(ops/csrc/paged_attention.cu)",
        grid=grid, loop=(per if wide else NB,), operands=tuple(ops),
        tables=(("tables", spec((S, NB), tables.dtype)),
                ("qpos", spec((S, K), qpos.dtype))),
        scratch=(torch.float32,))


def _check_on(dev: torch.device, tensors) -> None:
    for t in tensors:
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"paged_attention: a tensor lies on "
                             f"{t.device}, expected {dev}")


def paged_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    tables: torch.Tensor, qpos: torch.Tensor, *,
                    block_size: int, kscale: torch.Tensor | None = None,
                    vscale: torch.Tensor | None = None,
                    _layout: str = "auto", device=None) -> torch.Tensor:
    """Fused paged attention over one layer's physical block pool.

    ``q``: [S, H, K, dh] f32 queries (K = 1 for the decode tick, any
    K >= 1: the verify step passes ``spec_k``);
    ``kc``/``vc``: [n_blocks+1, H, bs, dh] physical blocks (trash block 0
    included) in f32, bf16, int8 or fp8 — typically ``pool[li]``, a view
    of the ``[L, ...]`` pool, passed by pointer and strides with no copy;
    ``tables``: [S, NB] int32 logical->physical ids; ``qpos``: [S, K]
    int32 query positions, non-decreasing along K. A quantised pool passes
    ``kscale``/``vscale`` [n_blocks+1, H, bs] f32 per-row scales.

    Returns f32 [S, H, K, dh]. ``_layout`` is accepted and validated for
    the JAX signature's sake; the one natural-layout kernel serves every
    value (the packed layout was a TPU lane-tiling workaround).

    ``device`` (None = ``"cuda"``) is where the call must run: the
    tensors must lie there. CUDA launches the kernel (counted in
    ``paged_attention.launches``); the CPU computes the plain version.
    """
    dev = resolve_device(device)
    if q.dim() != 4:
        raise ValueError(f"q must be [S, H, K, dh], got {tuple(q.shape)}")
    S, H, K, dh = q.shape
    bs = int(block_size)
    if kc.dim() != 4 or vc.shape != kc.shape:
        raise ValueError(f"kc/vc must both be [n_blocks, H, bs, dh], got "
                         f"{tuple(kc.shape)} / {tuple(vc.shape)}")
    if kc.shape[-2] != bs:
        raise ValueError(f"kc block axis {kc.shape[-2]} != block_size {bs}")
    if kc.shape[1] != H or kc.shape[3] != dh:
        raise ValueError(f"kc heads/head dim {tuple(kc.shape)} do not match "
                         f"q {tuple(q.shape)}")
    quant = kscale is not None
    if quant != (vscale is not None):
        raise ValueError("pass both kscale and vscale, or neither")
    if _layout not in ("auto", "natural", "packed"):
        raise ValueError(f"_layout must be auto/natural/packed, "
                         f"got {_layout!r}")
    if tables.dim() != 2 or tables.shape[0] != S:
        raise ValueError(f"tables must be [S={S}, NB], got "
                         f"{tuple(tables.shape)}")
    if tuple(qpos.shape) != (S, K):
        raise ValueError(f"qpos must be [S={S}, K={K}], got "
                         f"{tuple(qpos.shape)}")
    if kc.dtype in _QUANTIZED and not quant:
        raise ValueError(f"a {kc.dtype} pool needs its kscale/vscale planes")
    scales = [kscale, vscale] if quant else []
    if quant and (tuple(kscale.shape) != tuple(kc.shape[:-1])
                  or tuple(vscale.shape) != tuple(kc.shape[:-1])):
        raise ValueError(f"kscale/vscale must be {tuple(kc.shape[:-1])}")
    _check_on(dev, [q, kc, vc, tables, qpos, *scales])
    _kernels.note(lambda: launch_spec(q, kc, vc, tables, qpos, block_size=bs,
                                      kscale=kscale, vscale=vscale))
    if _trace.is_fake(q):
        # a program trace: the launch is a graph node, nothing runs
        return torch.ops.sdml.paged_attention(q, kc, vc, tables, qpos, bs,
                                              kscale, vscale)
    if dev.type == "cpu":
        return paged_attention_reference(q, kc, vc, tables, qpos,
                                         block_size=bs, kscale=kscale,
                                         vscale=vscale)
    return _launch(q, kc, vc, tables, qpos, bs, kscale, vscale)


paged_attention.launches = 0


@torch.library.custom_op("sdml::paged_attention", mutates_args=())
def _paged_attention_op(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        tables: torch.Tensor, qpos: torch.Tensor,
                        block_size: int, kscale: torch.Tensor | None,
                        vscale: torch.Tensor | None) -> torch.Tensor:
    """K4 as a graph node: on real tensors the wrapper's own path."""
    return paged_attention(q, kc, vc, tables, qpos, block_size=block_size,
                           kscale=kscale, vscale=vscale, device=q.device)


@_paged_attention_op.register_fake
def _(q, kc, vc, tables, qpos, block_size, kscale, vscale):
    return q.new_empty(tuple(q.shape), dtype=torch.float32)


def _launch(q, kc, vc, tables, qpos, bs, kscale, vscale) -> torch.Tensor:
    S, H, K, dh = q.shape
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("q must be contiguous float32")
    if kc.dtype not in _KERNEL_DTYPES or vc.dtype != kc.dtype:
        raise ValueError(f"kc/vc dtype {kc.dtype}/{vc.dtype}: the kernel "
                         f"takes {sorted(map(str, _KERNEL_DTYPES))}")
    if kc.stride(-1) != 1 or vc.stride(-1) != 1:
        raise ValueError("kc/vc head dim must be contiguous (stride 1)")
    for name, t in (("tables", tables), ("qpos", qpos)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    quant = kscale is not None
    if quant and (kscale.dtype != torch.float32
                  or vscale.dtype != torch.float32):
        raise ValueError("kscale/vscale must be float32")
    out = torch.empty((S, H, K, dh), dtype=torch.float32, device=q.device)
    scale_strides = (tuple(kscale.stride()) + tuple(vscale.stride())
                     if quant else (0,) * 6)
    strides = (ctypes.c_longlong * 12)(*kc.stride()[:3], *vc.stride()[:3],
                                       *scale_strides)
    built = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = built.lib.sdml_paged_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        kscale.data_ptr() if quant else None,
        vscale.data_ptr() if quant else None,
        tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
        S, H, K, dh, bs, tables.shape[1], strides,
        _KERNEL_DTYPES[kc.dtype], key_parts(dh, H, tables.shape[1]), stream)
    if rc != 0:
        msg = built.lib.sdml_cuda_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    paged_attention.launches += 1
    return out


def paged_flash_decode(q, kc, vc, tables, pos, *, block_size: int,
                       kscale=None, vscale=None, device=None) -> torch.Tensor:
    """The one-query-per-slot decode tick: ``q`` [S, H, 1, dh], ``pos``
    [S] — the ``K = 1`` case of :func:`paged_attention`."""
    return paged_attention(q, kc, vc, tables, pos[:, None].contiguous(),
                           block_size=block_size, kscale=kscale,
                           vscale=vscale, device=device)
