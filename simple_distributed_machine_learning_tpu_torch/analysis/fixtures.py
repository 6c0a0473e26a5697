"""Seeded-defect fixtures: launches the kernel linter MUST flag (and clean
twins it must not), the protocol checker's seeded models, and the grid
fixture's kernel F1 (port of ``analysis/fixtures.py``).

Each kernel fixture is a :class:`~.kernels.LaunchSpec` of one of the
port's own kernels with one defect:

- the paged-attention kernel K4's spec (``ops/paged_attention.py::
  launch_spec``) under a block-table contract one past the pool
  (``kernel-oob``) or within it (clean); with an int8 head dim of 4 in the
  contiguous slot (``kernel-tile``: 4 bytes of each 16-byte vector used)
  or transposed (clean) — plain specs, never launched;
- the grid kernel F1 (:func:`grid_scratch`, CUDA in
  ``ops/csrc/grid_scratch.cu``): ``o = cast(cast(x, scratch) * 2)``
  through an f32 or f16 scratch, one grid cell per row. Its fixtures RUN
  it, on the given device, and lint the spec it recorded: the racing
  variant maps every cell's output to row 0 (``kernel-race``), the f16
  scratch drifts (``kernel-dtype-drift``).

The program fixtures are tiny distributed steps written the way the
port writes real ones (per-coordinate tensors of one process, the
``parallel/`` collectives, in-place updates), each with one defect the
program linter must flag, and clean twins it must not:

- ``partial_ppermute`` — a four-rank ring whose rank 0 skips its receive
  (the wraparound hop): rank 3's send is never received
  (``ppermute-deadlock``, over the traced step of every rank);
- ``dropped_grad_sync`` / ``clean_grad_sync`` — data-parallel SGD over
  four coordinates with and without the gradient mean
  (``unreduced-gradient``);
- ``wrong_axis_name`` — the tensor-parallel sum pasted into a
  data-parallel step: a sum over a ``model`` axis the mesh binds one wide
  (``mesh-axis``);
- ``bf16_psum_accumulator`` — a bf16 sum over the data axis into a bf16
  running sum over 32 unrolled steps (``dtype-drift``);
- ``read_after_donate`` — a "snapshot" that is an alias of a buffer the
  program then updates in place (``donation``);
- ``oob_block_table`` — the paged decode step under a block-table
  contract one past the pool (``scatter-bounds``);
- ``cow_read_after_donate`` / ``clean_cow_tick`` — a tick whose CoW copy
  reads pool views taken before the prefill chunk wrote the pool, and the
  tick with the pool threaded (``donation``);
- ``unmemoized_retrace`` — a decode builder without the build memo
  (``retrace-explosion``);
- ``dropped_gather_before_use`` / ``clean_gather_before_use`` — a ZeRO
  opt-state shard consumed without (and with) its reduction
  (``sharded-state``);
- ``clean_pipeline_step`` — a 2-stage, 2-replica GPipe train step.

``tests/test_torch_kernel_lint.py`` and ``tests/test_torch_program_lint.py``
hold every fixture to the verdict the JAX tests record; the CLI's
``--fixtures`` re-runs the same contract (non-zero exit when any fixture
misbehaves), plus the chaos drill coverage lint and the replay of the
checker's exported counterexample on a real fleet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from simple_distributed_machine_learning_tpu_torch._device import (
    resolve_device,
)
from simple_distributed_machine_learning_tpu_torch.analysis import (
    kernels as _kernels,
)
from simple_distributed_machine_learning_tpu_torch.analysis.report import (
    Report,
)


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    family: str              # rule family expected in the findings
    defect: bool             # True: must flag; False: must be clean
    description: str
    build: Callable[..., Report]      # build(device=None) -> Report


# -- F1: the grid kernel --------------------------------------------------

#: scratch dtypes the kernel is instantiated for -> its code
_SCRATCH = {torch.float32: 0, torch.float16: 1}


def grid_scratch_spec(rows: int, cols: int, *, racing: bool,
                      scratch_dtype=torch.float32):
    """F1's :class:`~.kernels.LaunchSpec`: grid ``(rows,)`` parallel, the
    input block ``(1, cols)`` at ``(i, 0)``, the output block at
    ``(i, 0)`` — or ``(0, 0)`` for every cell when ``racing`` (what an
    autotuner mutation that drops the output index silently does) — and
    the scratch row's dtype."""

    def at_row(i):
        return (i, 0)

    def at_first_row(i):
        return (0, 0)

    return _kernels.LaunchSpec(
        kernel="grid_scratch",
        where=f"{__name__}.grid_scratch (ops/csrc/grid_scratch.cu)",
        grid=(int(rows),),
        operands=(
            _kernels.Operand("x", (rows, cols), (1, cols), torch.float32,
                             at_row),
            _kernels.Operand("out", (rows, cols), (1, cols), torch.float32,
                             at_first_row if racing else at_row,
                             output=True)),
        scratch=(scratch_dtype,))


def _out_rows(spec) -> list[int]:
    """The output row of each grid cell, from the spec's own index map."""
    return [_kernels.concrete(spec, "out", i)[0] for i in range(spec.grid[0])]


def grid_scratch_reference(x: torch.Tensor, *, racing: bool,
                           scratch_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: the grid walked in order, each cell's row
    cast to the scratch dtype, doubled there, cast back and stored at the
    row its index map gives (a later cell overwrites an earlier one, as on
    the TPU's sequential grid). Rows no cell maps to stay NaN."""
    spec = grid_scratch_spec(*x.shape, racing=racing,
                             scratch_dtype=scratch_dtype)
    out = torch.full(x.shape, float("nan"), dtype=torch.float32,
                     device=x.device)
    for i, r in enumerate(_out_rows(spec)):
        out[r] = (x[i].to(scratch_dtype) * 2).to(torch.float32)
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use only) and bind ``csrc/grid_scratch.cu``."""
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (
        build,
    )
    built = build("sdml_grid_scratch", ["grid_scratch.cu"])
    fn = built.lib.sdml_grid_scratch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    built.lib.sdml_grid_scratch_error_string.argtypes = [ctypes.c_int]
    built.lib.sdml_grid_scratch_error_string.restype = ctypes.c_char_p
    return built


def build_kernel():
    """Build and load F1's library now; returns the ``BuiltLibrary``."""
    return _library()


def grid_scratch(x: torch.Tensor, *, racing: bool,
                 scratch_dtype=torch.float32, device=None) -> torch.Tensor:
    """F1: ``out[row(i)] = cast(cast(x[i], scratch_dtype) * 2)`` for each
    grid cell ``i`` of the ``[R, C]`` f32 ``x``, through a scratch row of
    ``scratch_dtype`` (f32 or f16). ``row(i)`` is the spec's output index
    map: ``i``, or 0 for every cell when ``racing``. The output starts as
    NaN, so rows no cell writes read NaN on both paths.

    ``device`` (None = ``"cuda"``) is where the call runs: ``x`` must lie
    there. CUDA launches the kernel (counted in ``grid_scratch.launches``)
    or raises; the CPU computes :func:`grid_scratch_reference`."""
    dev = resolve_device(device)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a [R, C] float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if scratch_dtype not in _SCRATCH:
        raise ValueError(f"scratch_dtype must be one of "
                         f"{sorted(map(str, _SCRATCH))}, got {scratch_dtype}")
    if x.device.type != dev.type:
        raise ValueError(f"grid_scratch: x lies on {x.device}, expected "
                         f"{dev}")
    spec = grid_scratch_spec(*x.shape, racing=racing,
                             scratch_dtype=scratch_dtype)
    _kernels.note(lambda: spec)
    if dev.type == "cpu":
        return grid_scratch_reference(x, racing=racing,
                                      scratch_dtype=scratch_dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.full(x.shape, float("nan"), dtype=torch.float32,
                     device=x.device)
    out_row = torch.tensor(_out_rows(spec), dtype=torch.int32).to(x.device)
    launch(x, out, out_row, scratch_dtype)
    return out


grid_scratch.launches = 0


def launch(x, out, out_row, scratch_dtype) -> None:
    """One launch of the kernel on prepared CUDA buffers (``x`` and
    ``out`` [R, C] f32 contiguous, ``out_row`` [R] int32)."""
    built = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = built.lib.sdml_grid_scratch(
        x.data_ptr(), out.data_ptr(), out_row.data_ptr(), x.shape[0],
        x.shape[1], _SCRATCH[scratch_dtype], stream)
    if rc != 0:
        msg = built.lib.sdml_grid_scratch_error_string(rc).decode()
        raise RuntimeError(f"grid_scratch kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    grid_scratch.launches += 1


#: the numpy seed of :func:`grid_input`
_GRID_SEED = 0


def grid_input(device=None) -> torch.Tensor:
    """The grid fixture's input: a (4, 128) f32 array from a numpy seed."""
    x = np.random.default_rng(_GRID_SEED).standard_normal((4, 128))
    return torch.from_numpy(x.astype(np.float32)).to(resolve_device(device))


# -- kernel-*: seeded defects in launch specs -----------------------------

def _paged_spec(table_hi_slack: int, *, dh: int, bs: int,
                dtype=torch.float32, layout: str = "natural"):
    """K4's launch spec on synthetic shapes (the JAX fixture's: 2 slots, 2
    heads, 1 query, 3 logical blocks, a 5-block pool), with a block-table
    contract reaching ``n_blocks + table_hi_slack`` — slack 0 is the
    pool's invariant (clean), slack 1 a table that can point one block
    past the pool (kernel-oob). ``layout="packed"`` transposes the K/V
    blocks' trailing dims (a layout K4 does not run: a spec only)."""
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        launch_spec,
    )
    S, H, K, NB, n_blocks = 2, 2, 1, 3, 5

    def meta(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")

    kv = meta((n_blocks + 1, H, bs, dh), dtype)
    scale = (meta((n_blocks + 1, H, bs))
             if dtype.itemsize == 1 else None)
    spec = launch_spec(meta((S, H, K, dh)), kv, kv,
                       meta((S, NB), torch.int32), meta((S, K), torch.int32),
                       block_size=bs, kscale=scale, vscale=scale)
    if layout == "packed":
        spec = dataclasses.replace(spec, operands=tuple(
            dataclasses.replace(op, shape=op.shape[:2] + op.shape[:1:-1],
                                block=op.block[:2] + op.block[:1:-1])
            if op.name in ("k", "v") else op for op in spec.operands))
    return spec.with_contracts(tables=(0, n_blocks + table_hi_slack),
                               qpos=(0, NB * bs - 1))


def _spec_report(spec, name: str) -> Report:
    return _kernels.lint_report([spec], name=f"fixture:{name}")


def kernel_oob_index_map(device=None) -> Report:
    """K4's K/V index map fed a block-table contract that can reach one
    past the pool: the launch would read a block outside the buffer."""
    return _spec_report(_paged_spec(1, dh=8, bs=4), "kernel_oob_index_map")


def kernel_clean_paged(device=None) -> Report:
    """The same spec under the pool's table invariant — every index map
    proves in bounds (must be fully clean)."""
    return _spec_report(_paged_spec(0, dh=8, bs=4), "kernel_clean_paged")


def kernel_bad_tile(device=None) -> Report:
    """An int8 pool with head dim 4 in the contiguous slot at block size
    128: each row's 4 bytes take a 16-byte vector, 4x the bytes (the card's
    form of the small-head-dim hazard)."""
    return _spec_report(_paged_spec(0, dh=4, bs=128, dtype=torch.int8),
                        "kernel_bad_tile")


def kernel_packed_tile(device=None) -> Report:
    """The same blocks transposed: block positions contiguous, the small
    head dim strided (must be clean)."""
    return _spec_report(_paged_spec(0, dh=4, bs=128, dtype=torch.int8,
                                    layout="packed"), "kernel_packed_tile")


def _grid_kernel_report(racing: bool, scratch_dtype, name: str,
                        device=None) -> Report:
    """Run F1 once on ``device`` and lint the spec its launch recorded."""
    with _kernels.record_launches() as log:
        grid_scratch(grid_input(device), racing=racing,
                     scratch_dtype=scratch_dtype, device=device)
    return _kernels.lint_report(log, name=f"fixture:{name}")


def kernel_grid_race(device=None) -> Report:
    return _grid_kernel_report(True, torch.float32, "kernel_grid_race",
                               device)


def kernel_clean_grid(device=None) -> Report:
    return _grid_kernel_report(False, torch.float32, "kernel_clean_grid",
                               device)


def kernel_f16_accumulator(device=None) -> Report:
    """The grid kernel's scratch in f16: state carried below f32 drifts
    from the dense path's f32 math (the bit-exactness contract)."""
    return _grid_kernel_report(False, torch.float16,
                               "kernel_f16_accumulator", device)


def kernel_f32_accumulator(device=None) -> Report:
    return _grid_kernel_report(False, torch.float32,
                               "kernel_f32_accumulator", device)


# -- program fixtures: seeded defects in traced steps ----------------------

def _dev(device):
    return resolve_device(device)


def _data_mesh(device, n: int = 4):
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    return make_mesh(1, n_data=n, devices=[_dev(device)] * n)


def _analyze(fn, *args, mesh=None, name: str, device=None):
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        analyze,
    )
    return analyze(fn, *args, mesh=mesh, name=f"fixture:{name}")


def _fake(shape, dtype, device):
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        fake_mode,
    )
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype, device=_dev(device))


def partial_ppermute(device=None) -> Report:
    """A ring over four ranks (each its own process, traced alone): every
    rank sends to the next, but rank 0 skips its receive — the wraparound
    hop. Rank 3's send has no receiver."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        trace,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.rules import (
        check_ranks,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    n = 4

    def shift(x, rank):
        pending = [mesh_lib.send(x, (rank + 1) % n, tag=7)]
        if rank > 0:
            # BUG: rank 0 never receives rank 3's chunk
            x = mesh_lib.recv(x.shape, x.dtype, rank - 1, x.device, tag=7)
        mesh_lib.wait_all(pending)
        return x

    x = _fake((8, 16), torch.float32, device)
    programs = [trace.trace_program(shift, x, r, name=f"shift[rank {r}]")
                for r in range(n)]
    return Report(name="fixture:partial_ppermute",
                  findings=check_ranks(programs, "shift"))


def _dp_sgd_report(sync: bool, name: str, device=None) -> Report:
    """SGD over four data coordinates in one process: each coordinate's
    replica of ``w`` (shape replicated, ``[16, 4]``) takes a gradient
    from its own two rows of the batch ``x`` ``[8, 16]`` (seeded with the
    data axis where they are sliced, as ``Pipeline._replica_batches``
    seeds a replica's rows); with ``sync`` the gradients are averaged
    over the axis first."""
    from simple_distributed_machine_learning_tpu_torch.analysis import (
        trace,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        AxisView,
        axis_mean,
    )
    mesh = _data_mesh(device)
    view = AxisView.local("data", 4)

    def step(ws, x):
        xs = [x[2 * d:2 * d + 2] for d in range(len(ws))]
        trace.note_vary(xs, "data")
        grads = []
        for w, x in zip(ws, xs):
            wd = w.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = ((x @ wd) ** 2).mean()
                grads.append(torch.autograd.grad(loss, wd)[0])
        if sync:
            grads = [axis_mean(grads, view)] * len(grads)
        # else BUG: each coordinate applies only ITS rows' gradient to a
        # replica every coordinate must hold identically
        with torch.no_grad():
            for w, g in zip(ws, grads):
                w.sub_(0.1 * g)
        return ws

    ws = [_fake((16, 4), torch.float32, device) for _ in range(4)]
    x = _fake((8, 16), torch.float32, device)
    return _analyze(step, ws, x, mesh=mesh, name=name)


def dropped_grad_sync(device=None) -> Report:
    return _dp_sgd_report(False, "dropped_grad_sync", device)


def clean_grad_sync(device=None) -> Report:
    return _dp_sgd_report(True, "clean_grad_sync", device)


def wrong_axis_name(device=None) -> Report:
    """A tensor-parallel stage fn pasted into a data-parallel launch: the
    four data coordinates' values summed with ``model_sum`` — over a
    ``model`` axis the mesh binds one wide."""
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
        model_sum,
    )
    mesh = _data_mesh(device)

    def reduce(xs):
        # BUG: the mesh has no four-wide 'model' axis
        return model_sum(list(xs))

    xs = [_fake((2, 16), torch.float32, device) for _ in range(4)]
    return _analyze(reduce, xs, mesh=mesh, name="wrong_axis_name")


def bf16_psum_accumulator(device=None) -> Report:
    """A bf16 sum over the data axis added into a bf16 running sum, one
    step per row of the 32-step input: the loop unrolls in the trace."""
    from simple_distributed_machine_learning_tpu_torch.parallel.tensor import (
        model_sum,
    )
    mesh = _data_mesh(device)

    def accumulate(xs):
        acc = torch.zeros((16,), dtype=torch.bfloat16, device=xs[0].device)
        for t in range(xs[0].shape[0]):
            # BUG x2: the cross-coordinate sum runs in bf16, and the
            # running sum is carried in bf16
            total = model_sum([x[t] for x in xs], axis="data", size=4)
            acc = acc + total.sum(0)
        return acc

    xs = [_fake((32, 2, 16), torch.bfloat16, device) for _ in range(4)]
    return _analyze(accumulate, xs, mesh=mesh, name="bf16_psum_accumulator")


def read_after_donate(device=None) -> Report:
    """The port's donation is an in-place update: a "snapshot" taken as an
    alias (``detach``) of the buffer before the update holds the updated
    bytes when it is read after it."""

    def update_(buf, grads):
        with torch.no_grad():
            buf.sub_(0.1 * grads)
        return buf

    def two_phase(buf, grads):
        before = buf.detach()        # BUG: an alias, not a copy
        new_buf = update_(buf, grads)
        drift = (new_buf - before).sum()
        return new_buf, drift

    b = _fake((1024,), torch.float32, device)
    g = _fake((1024,), torch.float32, device)
    return _analyze(two_phase, b, g, name="read_after_donate")


def _tiny_serve(device=None):
    """One tiny GPT build shared by the serve fixtures."""
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    cfg = GPTConfig(vocab=16, seq_len=16, d_model=8, n_heads=2, n_layers=1)
    return cfg, make_gpt_stages(0, cfg, 1, device=_dev(device))[0]


def oob_block_table(device=None) -> Report:
    """The paged decode step handed a block-table contract that can reach
    one past the pool: the K/V scatter provably lands outside
    ``n_blocks + 1`` — another request's blocks."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_paged_decode_step,
    )
    cfg, stages = _tiny_serve(device)
    S, ml, bs = 2, 12, 4
    NB, n_blocks = 3, 6
    step = make_paged_decode_step(stages, cfg, ml, bs, device=_dev(device))
    params = abstractify([s.params for s in stages])
    kc = _fake((1, n_blocks + 1, 2, bs, 4), torch.float32, device)
    vc = _fake((1, n_blocks + 1, 2, bs, 4), torch.float32, device)
    return _analyze(
        step, params, kc, vc,
        spec((S,), torch.int32, 0, cfg.vocab - 1),
        spec((S,), torch.int32, 0, ml - 1),
        # BUG: entries may reach n_blocks + 1 — one past the last block
        spec((S, NB), torch.int32, 0, n_blocks + 1),
        spec((S, 2), torch.int64), spec((S,), torch.float32),
        spec((S,), torch.int32, 0, cfg.vocab), spec((S,), torch.float32),
        name="oob_block_table")


def _cow_tick_report(threaded: bool, name: str, device=None) -> Report:
    """A prefill chunk, then a CoW copy of block 1 into block 2. The
    threaded tick copies on the pool the chunk returns; the defect copies
    through views of the pool taken before the chunk wrote it."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_paged_block_copy,
        make_paged_prefill_chunk,
    )
    cfg, stages = _tiny_serve(device)
    ml, bs, n_blocks = 12, 4, 6
    chunk = make_paged_prefill_chunk(stages, cfg, ml, bs,
                                     device=_dev(device))
    copy = make_paged_block_copy()

    def tick(params, kc, vc, tokens, p0, table, kd, t, k_, p_):
        old_k, old_v = kc[:], vc[:]
        kc2, vc2, tok, _kd2 = chunk(params, kc, vc, tokens, p0, table, kd,
                                    t, k_, p_)
        if threaded:
            kc3, vc3 = copy(kc2, vc2, 2, 1)
        else:
            # BUG: the copy reads the pool through views taken before
            # the chunk overwrote it in place
            kc3, vc3 = copy(old_k, old_v, 2, 1)
        return kc3, vc3, tok

    params = abstractify([s.params for s in stages])
    kc = _fake((1, n_blocks + 1, 2, bs, 4), torch.float32, device)
    vc = _fake((1, n_blocks + 1, 2, bs, 4), torch.float32, device)
    return _analyze(
        tick, params, kc, vc,
        spec((1, 3), torch.int32, 0, cfg.vocab - 1), ml - 4,
        spec((3,), torch.int32, 0, n_blocks), spec((2,), torch.int64),
        spec((), torch.float32), spec((), torch.int32, 0, cfg.vocab),
        spec((), torch.float32), name=name)


def cow_read_after_donate(device=None) -> Report:
    return _cow_tick_report(False, "cow_read_after_donate", device)


def clean_cow_tick(device=None) -> Report:
    return _cow_tick_report(True, "clean_cow_tick", device)


def unmemoized_retrace(device=None) -> Report:
    """A decode builder that makes its program afresh on every call
    instead of routing through the build memo — each engine and test
    would rebuild an identical program."""
    from simple_distributed_machine_learning_tpu_torch.analysis.programs import (  # noqa: E501
        check_builder_memo,
    )

    def bad_make_decode():
        def decode(tok):
            return tok + 1
        return decode

    return Report(name="fixture:unmemoized_retrace",
                  findings=check_builder_memo("bad_make_decode",
                                              bad_make_decode))


def _zero1_report(reduced: bool, name: str, device=None) -> Report:
    """ZeRO style over four data coordinates: ``ms[d]`` is coordinate
    ``d``'s OWN opt-state shard in a replicated-shape buffer (declared
    ``spec(..., vary=("data",))``); with ``reduced`` the new momentum is
    averaged over the axis before it updates the replicated params."""
    from simple_distributed_machine_learning_tpu_torch.analysis.bounds import (
        spec,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        AxisView,
        axis_mean,
    )
    mesh = _data_mesh(device)
    view = AxisView.local("data", 4)

    @torch.no_grad()
    def step(ws, ms, gs):
        m2 = [0.9 * m + g for m, g in zip(ms, gs)]
        if reduced:
            m2 = [axis_mean(m2, view)] * len(m2)
        # else BUG: each coordinate updates the replicated params with ITS
        # shard's momentum — the params silently diverge over the axis
        for w, m, new in zip(ws, ms, m2):
            w.sub_(0.1 * new)
            m.copy_(new)
        return ws, ms

    ws = [_fake((16, 4), torch.float32, device) for _ in range(4)]
    gs = [_fake((16, 4), torch.float32, device) for _ in range(4)]
    ms = [spec((16, 4), torch.float32, vary=("data",), device=_dev(device))
          for _ in range(4)]
    return _analyze(step, ws, ms, gs, mesh=mesh, name=name)


def dropped_gather_before_use(device=None) -> Report:
    return _zero1_report(False, "dropped_gather_before_use", device)


def clean_gather_before_use(device=None) -> Report:
    return _zero1_report(True, "clean_gather_before_use", device)


def clean_pipeline_step(device=None) -> Report:
    """A 2-stage, 2-replica GPipe train step of the MLP (dims 16, 16, 10;
    SGD with momentum; 2 microbatches of 2 rows each): must be clean."""
    from simple_distributed_machine_learning_tpu_torch.analysis.preflight import (  # noqa: E501
        abstract_batch,
    )
    from simple_distributed_machine_learning_tpu_torch.analysis.trace import (
        abstractify,
    )
    from simple_distributed_machine_learning_tpu_torch.models.mlp import (
        make_mlp_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel.pipeline import (  # noqa: E501
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train.optimizer import (
        sgd,
    )
    from simple_distributed_machine_learning_tpu_torch.train.step import (
        make_train_step,
    )
    dev = _dev(device)
    stages, wire, out = make_mlp_stages(0, [16, 16, 10], 2, device=dev)
    mesh = make_mesh(2, n_data=2, devices=[dev] * 4)
    pipe = Pipeline(stages, mesh, wire, out, n_microbatches=2)
    opt = sgd(0.1, momentum=0.5)
    params = pipe.init_params()
    state = abstractify(opt.init(params))
    x, t = abstract_batch(pipe, 8, (16,))
    return _analyze(make_train_step(pipe, opt), abstractify(params), state,
                    x, t, 0, mesh=mesh, name="clean_pipeline_step")


# -- protocol: seeded defects in the abstract fleet model -----------------

def _protocol(name: str):
    def build(device=None) -> Report:
        from simple_distributed_machine_learning_tpu_torch.analysis import (
            protocol,
        )
        return protocol.check_protocol(getattr(protocol, name))
    build.__name__ = f"protocol_{name.lower()}"
    return build


protocol_dropped_handoff = _protocol("DROPPED_TOMBSTONE")
protocol_legacy_handoff_order = _protocol("LEGACY_ORDER")
protocol_skipped_refund = _protocol("SKIPPED_REFUND")
protocol_ungated_boarding = _protocol("UNGATED_BOARDING")
protocol_clean_fleet = _protocol("CLEAN")


FIXTURES: dict[str, Fixture] = {f.name: f for f in [
    Fixture("partial_ppermute", "ppermute-deadlock", True,
            "ring whose first rank skips its receive (the wraparound hop)",
            partial_ppermute),
    Fixture("dropped_grad_sync", "unreduced-gradient", True,
            "data-parallel update without the gradient mean",
            dropped_grad_sync),
    Fixture("wrong_axis_name", "mesh-axis", True,
            "sum over a model axis the mesh binds one wide",
            wrong_axis_name),
    Fixture("bf16_psum_accumulator", "dtype-drift", True,
            "bf16 cross-coordinate sum into a bf16 running sum",
            bf16_psum_accumulator),
    Fixture("read_after_donate", "donation", True,
            "alias of a buffer read after its in-place update",
            read_after_donate),
    Fixture("oob_block_table", "scatter-bounds", True,
            "paged decode with a block-table contract one past the pool",
            oob_block_table),
    Fixture("cow_read_after_donate", "donation", True,
            "CoW block copy through pool views the prefill chunk overwrote",
            cow_read_after_donate),
    Fixture("unmemoized_retrace", "retrace-explosion", True,
            "decode builder rebuilding its program outside the memo",
            unmemoized_retrace),
    Fixture("dropped_gather_before_use", "sharded-state", True,
            "ZeRO opt-state shard consumed without its reduction",
            dropped_gather_before_use),
    Fixture("kernel_oob_index_map", "kernel-oob", True,
            "fused paged kernel with a block-table contract past the pool",
            kernel_oob_index_map),
    Fixture("kernel_grid_race", "kernel-race", True,
            "grid kernel output map collapsing a parallel grid axis",
            kernel_grid_race),
    Fixture("kernel_bad_tile", "kernel-tile", True,
            "int8 head dim 4 in the contiguous slot (4x 16-byte vectors)",
            kernel_bad_tile),
    Fixture("kernel_f16_accumulator", "kernel-dtype-drift", True,
            "f16 scratch accumulator carried across grid iterations",
            kernel_f16_accumulator),
    Fixture("protocol_dropped_handoff", "protocol", True,
            "handoff sealed without journaling the source tombstone",
            protocol_dropped_handoff),
    Fixture("protocol_legacy_handoff_order", "protocol", True,
            "tombstone-then-copy handoff (pre-fix ordering, loses the rid)",
            protocol_legacy_handoff_order),
    Fixture("protocol_skipped_refund", "protocol", True,
            "shed/preempt path that never refunds the KV block refcounts",
            protocol_skipped_refund),
    Fixture("protocol_ungated_boarding", "protocol", True,
            "decode boarding not gated on the prefetch upload landing",
            protocol_ungated_boarding),
    Fixture("clean_grad_sync", "", False,
            "the dropped_grad_sync fixture with the mean restored",
            clean_grad_sync),
    Fixture("clean_cow_tick", "", False,
            "the CoW tick with the written pool threaded through",
            clean_cow_tick),
    Fixture("clean_gather_before_use", "", False,
            "the ZeRO update with the reduction restored (must be clean)",
            clean_gather_before_use),
    Fixture("clean_pipeline_step", "", False,
            "a 2-stage dp=2 GPipe train step (must be clean)",
            clean_pipeline_step),
    Fixture("kernel_clean_paged", "", False,
            "the fused paged kernel under the slots.py table invariant",
            kernel_clean_paged),
    Fixture("kernel_clean_grid", "", False,
            "the grid kernel with its output indexed by the parallel axis",
            kernel_clean_grid),
    Fixture("kernel_packed_tile", "", False,
            "the small-head-dim blocks transposed (positions contiguous)",
            kernel_packed_tile),
    Fixture("kernel_f32_accumulator", "", False,
            "the grid kernel with its scratch accumulator in f32",
            kernel_f32_accumulator),
    Fixture("protocol_clean_fleet", "", False,
            "the 2-pool fleet model with every defect knob off (proves)",
            protocol_clean_fleet),
]}


def _replay_exported_drill(device=None) -> tuple[bool, list[str]]:
    """The model checker's export must have teeth: the FaultPlan exported
    from the dropped-tombstone model's double-serve counterexample must
    replay as a REAL failure (more tokens streamed than the request asked
    for) on a live 3-replica disaggregated fleet carrying the same seeded
    defect (``log_handoff`` suppressed), and the intact twin must stay
    exactly-once under the identical kill schedule."""
    import os
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.analysis.protocol import (  # noqa: E501
        DROPPED_TOMBSTONE,
        check_protocol,
        export_fault_plan,
    )
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.resilience import (
        faults,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        RequestJournal,
        ServeFleet,
        engine_factory,
    )
    from simple_distributed_machine_learning_tpu_torch.serve.request import (
        DONE,
    )

    lines = []
    report = check_protocol(DROPPED_TOMBSTONE)
    viol = next((v for v in report.exploration.violations
                 if v.invariant == "double-serve"), None)
    if viol is None:
        return False, ["== exported-drill replay: model found no "
                       "double-serve counterexample -> FAILED"]
    plan_text, note = export_fault_plan(viol)
    if plan_text is None:
        return False, [f"== exported-drill replay: counterexample not "
                       f"expressible as a FaultPlan ({note}) -> FAILED"]
    lines.append(f"  exported plan: {plan_text}")

    dev = resolve_device(device)
    cfg = GPTConfig(vocab=32, seq_len=48, d_model=32, n_heads=2, n_layers=2)
    stages = make_gpt_stages(0, cfg, 2, device=dev)[0]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, 4).astype(
        np.int32)
    max_new = 3

    def run(drop_tombstone: bool) -> int:
        """Drive the model's scenario (submit -> prefill -> handoff ->
        DONE), then install the exported plan and keep ticking; returns
        total tokens streamed to the caller over the whole run."""
        faults.uninstall()
        orig = RequestJournal.log_handoff
        if drop_tombstone:
            RequestJournal.log_handoff = lambda self, **kw: None
        try:
            with tempfile.TemporaryDirectory() as td:
                fleet = ServeFleet(
                    engine_factory(stages, cfg, n_slots=2, block_size=4,
                                   prefill_chunk=3, device=dev),
                    os.path.join(td, "j"), n_replicas=3,
                    prefill_replicas=1, journal_sync=False)
                got = []
                h = fleet.submit(prompt, max_new_tokens=max_new, seed=11,
                                 on_token=lambda req, tok: got.append(tok))
                for _ in range(60):
                    fleet.step()
                    if h.state == DONE and fleet.handoffs >= 1:
                        break
                faults.install(faults.FaultPlan.parse(plan_text))
                for _ in range(len(plan_text.split(";")) + 1):
                    fleet.step()
                faults.uninstall()
                for _ in range(60):
                    if h.state == DONE:
                        break
                    fleet.step()
                fleet.close()
                return len(got)
        finally:
            RequestJournal.log_handoff = orig
            faults.uninstall()

    defect_tokens = run(drop_tombstone=True)
    clean_tokens = run(drop_tombstone=False)
    defect_good = defect_tokens > max_new
    clean_good = clean_tokens == max_new
    lines.append(f"  defect twin (log_handoff dropped): streamed "
                 f"{defect_tokens}/{max_new} tokens -> "
                 f"{'double-served as predicted' if defect_good else 'NO REAL FAILURE (vacuous export)'}")  # noqa: E501
    lines.append(f"  clean twin (tombstone intact):     streamed "
                 f"{clean_tokens}/{max_new} tokens -> "
                 f"{'exactly-once' if clean_good else 'UNEXPECTED FAILURE'}")
    ok = defect_good and clean_good
    lines.insert(0, f"== exported-drill replay: counterexample must fail a "
                    f"real fleet -> {'OK' if ok else 'FAILED'}")
    return ok, lines


def self_test(device=None) -> tuple[bool, str]:
    """Run every fixture against its contract (on ``device`` where it
    launches a kernel), plus the chaos drill coverage lint
    (``resilience.faults.drill_coverage``) and the exported drill's
    replay. Returns (ok, report_text) — the CLI ``--fixtures`` mode prints
    the text and exits 0 iff ok."""
    lines = []
    ok = True
    for fx in FIXTURES.values():
        report = fx.build(device)
        flagged = not report.ok(fail_on="warning")
        family_hit = (not fx.defect or
                      any(f.family == fx.family for f in report.findings))
        good = (flagged and family_hit) if fx.defect else not flagged
        ok = ok and good
        verdict = "OK" if good else "FIXTURE CONTRACT VIOLATED"
        want = (f"must flag [{fx.family}]" if fx.defect else "must be clean")
        lines.append(f"== {fx.name}: {want} -> {verdict}")
        lines.append(report.format(costs=False))
    from simple_distributed_machine_learning_tpu_torch.resilience.faults import (  # noqa: E501
        drill_coverage,
    )
    gaps = drill_coverage()
    verdict = "OK" if not gaps else "COVERAGE GAPS"
    lines.append(f"== fault drill coverage: every kind x site fired "
                 f"-> {verdict}")
    for g in gaps:
        lines.append(f"  MISSING: {g}")
        ok = False
    replay_ok, replay_lines = _replay_exported_drill(device)
    ok = ok and replay_ok
    lines.extend(replay_lines)
    return ok, "\n".join(lines)
