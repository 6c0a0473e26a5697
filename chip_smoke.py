#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port builds, is right, serves and trains on
one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It imports only the port (``simple_distributed_machine_learning_tpu_torch``)
and torch — no JAX — and exits non-zero, printing no result, without CUDA
or without the port beside it. Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of every kernel from the checkout's sources (one ``nvcc`` per
   source, started together, into the git-ignored ``_build/`` directory),
   with ptxas's registers and spills per kernel (a spill in K4, or in K1
   at a head dim up to 64, fails), and the count of tensor-core (``HMMA``)
   instructions in each kernel's SASS (``cuobjdump``): all 12 bf16 K1-K3
   instantiations must have some, the f32 flash kernels and K4 none;
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes (H = 8, dh = 64, block 16, 8 slots, positions up to
   255), for every cache dtype and K = 1 and 4, within rtol = atol =
   1e-5 (both read the same stored bytes); a narrow pool's answer also
   within ``tests/tolerances.py::attn_tol`` of the unquantised f32
   pool's; then K4's edge cases (``K4_EDGES``: head dims 40, 128, 256,
   blocks of 8 and 32, a table longer than the warp count, K = 4 and 8, a
   slot at position 0 beside a trash-routed one, a non-contiguous and a
   misaligned pool view) against the plain version. Each serving case is
   timed with CUDA events (one pair around a run of 40 calls, the L2
   flushed before each call, the flushes' own time subtracted; median of 5
   runs) beside its plain version and its bound, and K4 must beat its
   plain version at the f32 K = 1 case;
   then the flash kernels K1 (forward), K2 (dq) and K3 (dk/dv) against
   their plain versions, f32 and bf16, at the training shape (16, 8, 256,
   64), at a ragged T = 200 and at the tiny row's (32, 4, 64, 32), and in
   bf16 at the edges of the tensor-core K1-K3 (head dims 8, 32, 40 and
   128, T = 1, 65 and 200), within ``FLASH_TOL``, timed the same way
   beside their bounds and the library yardstick
   (``scaled_dot_product_attention``, forward and backward; K1 against
   SDPA's forward and K2 + K3 against SDPA's backward, each on one line);
3. the port's serving path at full width: ``InferenceEngine(attn_kernel=
   "fused")`` serving the ``gpt_serve`` trace (24 requests, Poisson
   32/s, prompts 8/16/32, 24 new tokens) on the 21 M-parameter GPT
   (vocab 8192, seq 256, d 512, 8 heads, 4 layers; random weights from
   seed 0). It must complete 24/24, launch the kernel n_layers times per
   decode tick, and give every greedy stream equal to an ``attn_kernel=
   "dense"`` engine's and to the solo ``make_cached_decoder``'s;
4. where a decode tick's time goes: a steady window at full occupancy (8
   slots), timed on the host clock, then traced with ``torch.profiler`` —
   the device's busy share and its time by kernel (``PERF.md`` section 5);
5. the port's training path: ``bench.py``'s ``gpt_bf16`` row at full width
   (21 M parameters, batch 16, bf16, AdamW) and its tiny ``gpt`` row (f32,
   SGD), each ``Pipeline`` + ``make_scanned_train_step`` with
   ``attn_impl="flash"`` for 30 steps over a pool of 2 random batches:
   finite losses that fall, K1-K3 launched exactly ``n_layers`` times per
   step, and losses equal to an ``attn_impl="dense"`` run's from the same
   weights within ``flash_vs_dense_rtol`` over 10 steps, while a run with
   a known-wrong attention core (its causal mask one key too wide) falls
   outside that limit;
6. where a full-width flash training step's time goes, under
   ``torch.profiler``; the bf16 K1 must show there by its tensor-core
   kernel's name, ``n_layers`` launches per step;
7. the reference's main path, through the port's CLI and ``Trainer`` on
   the card: LeNet for 2 epochs at the reference's sizing (6000/1000
   synthetic samples, batch 60, SGD lr 0.1 momentum 0.5) with a
   checkpoint directory and ``--metrics-json`` — every console line in
   the reference's formats, 2 schema-2 records, finite losses — and a
   rerun with ``--epochs 3`` that resumes at epoch 3; 20 deterministic
   SGD steps of LeNet on the card within ``rel=1e-4*(i+1)+1e-5`` of the
   port's CPU path from the same weights and batches, while a (C, H, W)
   flatten lands outside; ``mlp2`` (784-512-10) above 50% test accuracy
   after 2 epochs, and 1 + 1 resumed epochs equal to 2 straight, bit for
   bit, for ``mlp2`` and LeNet; ``--model gpt --attn flash --dryrun 5``
   through the CLI with K2 and K3 launched exactly ``n_layers`` times per
   step and K1 also once per layer per eval batch; and the ``lenet``,
   ``mlp2`` and ``mlp4`` rows' step time at batch 60 on the host clock,
   then under ``torch.profiler`` (device busy share, device and host ops
   per step).

Before the last line it prints the kernels as one JSON object (times in
ms, measured in this run; ``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = "simple_distributed_machine_learning_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores (K4's and the f32 flash kernels' products: TF32 is off) and
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# flash kernel shapes [B, H, T, dh]: the gpt_bf16 row (batch 16, 8 heads,
# seq 256, d 512), the same at a ragged T, and the tiny gpt row's f32
# shape (batch 32 as one fused microbatch, 4 heads, seq 64, d 128)
FLASH_SHAPE = (16, 8, 256, 64)
FLASH_RAGGED = (16, 8, 200, 64)
FLASH_TINY_SHAPE = (32, 4, 64, 32)
# bf16 edge shapes of the tensor-core K1-K3 at a small B*H: head dims padded
# to 32 and 128 and one not a multiple of 16 (40), each at T = 1 (one row),
# 65 (one row past a tile) and 200 (a ragged tail); dh 64 at T = 1, 65; and
# dh 8 (padded to 16, the smallest instantiation) at T = 65, 200
FLASH_EDGES = ([(2, 4, t, dh) for dh in (32, 40, 128) for t in (1, 65, 200)]
               + [(2, 4, t, 64) for t in (1, 65)]
               + [(2, 4, t, 8) for t in (65, 200)])
# (rtol, atol) of each flash kernel against its plain version, keyed by
# (dtype, is a row statistic l/m, is a gradient): f32 at 1e-5 (o, l, m) and
# 1e-4 (dq, dk, dv: tests/test_flash_attention.py's gradient tolerance);
# bf16 outputs within 2^-6 = two bf16 ulps at 1.0 (bf16 keeps 8 significant
# bits; the kernel's f32 sums run in another order, and K1 rounds p against
# its running max, the plain version against the final one); l and m stay
# f32 in both dtypes
_BF16_ULP2 = 2.0 ** -6
FLASH_TOL = {("float32", False, False): (1e-5, 1e-5),
             ("float32", True, False): (1e-5, 1e-5),
             ("float32", False, True): (1e-4, 1e-4),
             ("bfloat16", False, False): (_BF16_ULP2, _BF16_ULP2),
             ("bfloat16", True, False): (1e-5, 1e-5),
             ("bfloat16", False, True): (_BF16_ULP2, _BF16_ULP2)}
# (rtol, atol) of the kernel against its plain version: both read the same
# stored bytes and scales, so only f32 summation order differs
SAME_BYTES_TOL = (1e-5, 1e-5)
# tests/tolerances.py::attn_tol's (rtol, atol) per storage dtype: a narrow
# pool's answer against the unquantised f32 pool's
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 5e-2),
            "int8": (6e-2, 6e-2), "float8_e4m3fn": (1.5e-1, 1.5e-1),
            "float8_e5m2": (1.5e-1, 1.5e-1)}
# K4 edge cases beside the serving ones: (storage dtype, K, _pool_case
# options), each held against the plain version; every one also has a slot
# at position 0 with a real table entry beside the trash-routed slot
K4_EDGES = [("float32", 1, dict(dh=40)), ("float32", 1, dict(dh=128)),
            ("float32", 1, dict(dh=256)), ("bfloat16", 1, dict(dh=256)),
            ("int8", 1, dict(dh=40)),
            ("float32", 1, dict(bs=8)),     # 32 blocks: past the warp count
            ("float32", 1, dict(bs=32)), ("float32", 4, dict(bs=8)),
            ("float32", 8, {}), ("int8", 8, dict(dh=128)),
            ("float8_e4m3fn", 4, dict(dh=40, bs=32)),
            ("float32", 1, dict(layout="block-major")),
            ("bfloat16", 4, dict(layout="misaligned"))]
SERVE_CFG = dict(vocab=8192, seq_len=256, d_model=512, n_heads=8, n_layers=4)
SERVE_SLOTS, SERVE_BLOCK = 8, 16
# bench.py's gpt_bf16 and gpt rows (bench.py::_configs), trained on the
# port's main path with attn_impl="flash"; flash_vs_dense_rtol is the limit
# on the largest relative gap between a flash run's and a dense run's
# per-step losses from the same weights and batches. It sits between the
# gap of the sound flash path and that of a known-wrong one (the dense path
# with a causal mask one key too wide, the smallest gap of the wrong paths
# tried), about a factor of 7 from each in bf16; every run measures both
# gaps and fails unless the wrong one exceeds the limit. bf16 differs
# because the dense bf16 path rounds scores and probabilities to bf16
# where the kernels keep them in f32; f32 by summation order only.
TRAIN_ROWS = {
    "gpt_bf16": dict(cfg=dict(vocab=8192, seq_len=256, d_model=512,
                              n_heads=8, n_layers=4),
                     batch=16, n_micro=1, dtype="bfloat16", opt="adamw",
                     flash_vs_dense_rtol=2e-3),
    "gpt": dict(cfg=dict(vocab=128, seq_len=64, d_model=128, n_heads=4,
                         n_layers=2),
                batch=32, n_micro=4, dtype=None, opt="sgd",
                flash_vs_dense_rtol=1e-4),
}
TRAIN_POOL, TRAIN_STEPS, TRAIN_COMPARE_STEPS = 2, 30, 10
SERVE_SIM = dict(n_requests=24, rate=32.0, seed=0, prompt_lens=(8, 16, 32),
                 max_new_tokens=24)
# phase 7, the reference's main path: bench.py::_configs's mlp2 and mlp4
# widths (lenet is the reference's own model); the reference's console
# formats (tests/test_trainer.py) and the Trainer's throughput line
MLP2 = [784, 512, 10]
MLP4 = [784, 512, 512, 512, 10]
TRAIN_RE = re.compile(
    r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_RE = re.compile(
    r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) "
    r"\((\d+)%\)$")
EPOCH_RE = re.compile(r"^\| epoch (\d+): (\d+\.\d) samples/sec$")
# LeNet steps held against the port's CPU path; steps of each row's timing
# (warm-up, host-clock window, profiled window); GPT steps through the CLI
MAIN_COMPARE_STEPS = 20
MAIN_WARMUP_STEPS, MAIN_TIMED_STEPS, MAIN_PROFILED_STEPS = 20, 300, 20
MAIN_GPT_STEPS = 5
# where phase 7 runs: the card ("cpu" only to rehearse the phase without
# one, where its device checks cannot pass)
MAIN_DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _timed_run(body, n: int) -> float:
    """Device ms of ``n`` calls of ``body`` between one CUDA event pair.
    The run is enqueued behind a device-side spin, and counts only if the
    host finished enqueueing it before the device reached the start event:
    then no host dispatch time lies inside the pair. Otherwise the spin
    grows and the run shrinks (a full launch queue also blocks the host)."""
    import torch
    spin = 40_000_000                     # clock cycles, ~20 ms
    for _ in range(5):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(n):
            body()
        b.record()
        ahead = not a.query()
        torch.cuda.synchronize()
        if ahead:
            return a.elapsed_time(b) / n
        spin, n = 2 * spin, max(n // 2, 4)
    raise SmokeFailure("the host could not enqueue a timed run before the "
                       "device reached it")


def time_ms(fn, flush, n: int = 40, reps: int = 5) -> float:
    """Device time of one call of ``fn`` meeting a cold L2, as the decode
    tick meets each layer's K/V: runs of ``n`` (flush the L2 with a 64 MB
    write, call ``fn``) less runs of ``n`` flushes alone, each run between
    one event pair; the median of ``reps`` such differences."""
    for _ in range(3):
        fn()

    def both():
        flush.zero_()
        fn()

    return statistics.median(_timed_run(both, n) - _timed_run(flush.zero_, n)
                             for _ in range(reps))


def profiled_kernel_ms(fn, flush, name: str, n: int = 40) -> float:
    """Cross-check of :func:`time_ms`: the mean self device time of the
    kernels whose name holds ``name`` over ``n`` (flush, ``fn``) calls,
    as ``torch.profiler`` records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key:
            total += float(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0))
            count += e.count
    check(count == n, f"the profiler saw {count} launches of {name}, "
                      f"expected {n}")
    return total / count / 1e3


# -- phase 1 ------------------------------------------------------------------

def _toolkit_bin() -> str:
    from simple_distributed_machine_learning_tpu_torch.ops._cuda_build import (  # noqa: E501
        nvcc_path,
    )
    return os.path.dirname(nvcc_path())


def _demangled(counts: dict) -> dict:
    """``counts`` keyed by the demangled kernel names, where the toolkit
    has ``cu++filt``."""
    filt = os.path.join(_toolkit_bin(), "cu++filt")
    if counts and os.path.exists(filt):
        dem = subprocess.run([filt], input="\n".join(counts), text=True,
                             capture_output=True, timeout=60)
        if dem.returncode == 0 and len(dem.stdout.splitlines()) == len(counts):
            return dict(zip(dem.stdout.splitlines(), counts.values()))
    return counts


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``'s
    output: ``{name: {"registers", "spill_stores", "spill_loads"}}``."""
    import re
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name]["registers"] = int(m.group(1))
    return _demangled(out)


def _no_spill_required(name: str) -> bool:
    """K4 everywhere, and K1 at head dims up to 64: the bf16 tensor-core
    K1 padded to 16, 32 or 64, and the f32 SIMT K1's 4-column variant."""
    import re
    if "paged_attn_kernel" in name:
        return True
    m = re.search(r"flash_fwd_kernel(_bf16_mma)?(?:<(?:\(int\))?|ILi)(\d+)",
                  name)
    if not m:
        return False
    return int(m.group(2)) <= 64 if m.group(1) else int(m.group(2)) == 4


def sass_hmma_counts(lib_path) -> dict[str, int]:
    """Tensor-core (``HMMA``) instructions in each kernel of a built
    library, from ``cuobjdump -sass`` (beside ``nvcc``); names demangled
    with ``cu++filt`` where the toolkit has it."""
    out = subprocess.run([os.path.join(_toolkit_bin(), "cuobjdump"), "-sass",
                          str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts: dict[str, int] = {}
    name = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return _demangled(counts)


def phase_build(record: dict) -> None:
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        build_kernel,
    )
    record["card"] = card_line()
    print(f"chip_smoke: card {record['card']}")
    print(f"chip_smoke: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from simple_distributed_machine_learning_tpu_torch.ops.flash_attention import (  # noqa: E501
        build_kernel as build_flash,
    )
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(build_kernel), pool.submit(build_flash)]
        builds = [f.result() for f in futures]
    record["build_s"] = round(time.perf_counter() - t0, 3)
    ptxas: dict[str, dict] = {}
    for built in builds:
        print(f"chip_smoke: built {built.path.name} (nvcc "
              f"{built.build_s:.3f} s)")
        if not built.log:
            print("chip_smoke:   ptxas: no log (the library was built "
                  "earlier in this checkout)")
        ptxas.update(ptxas_report(built.log))
    for name, r in sorted(ptxas.items()):
        print(f"chip_smoke:   ptxas {r.get('registers', -1):4d} registers, "
              f"spill {r.get('spill_stores', -1)}/{r.get('spill_loads', -1)}"
              f" bytes  {name}")
    held = [n for n in ptxas if _no_spill_required(n)]
    # a fresh build reports the 4 K1 variants at dh <= 64 (f32, bf16 16 /
    # 32 / 64) and K4's 18 (5 storage types x K up to 1, 4, 8, and f32 at
    # dh > 128)
    check(not ptxas or len(held) == 4 + 18,
          f"ptxas reported {len(held)} K1/K4 kernels, not 22: {held}")
    spills = [n for n in held if ptxas[n].get("spill_stores", 0)
              or ptxas[n].get("spill_loads", 0)]
    check(not spills, f"K4 or K1 at dh <= 64 spills registers: {spills}")
    record["ptxas"] = ptxas
    print(f"chip_smoke: kernels built in {record['build_s']} s")
    hmma = sass_hmma_counts(builds[1].path)
    k4_hmma = sass_hmma_counts(builds[0].path)
    for name, n in sorted({**hmma, **k4_hmma}.items()):
        print(f"chip_smoke:   SASS HMMA {n:5d}  {name}")
    mma = {n: c for n, c in hmma.items() if "_bf16_mma" in n}
    # the bf16 K1, K2 and K3, each at head dims padded to 16, 32, 64, 128
    check(len(mma) == 12 and all(c > 0 for c in mma.values()),
          f"the bf16 K1-K3 kernels are not all on the tensor cores: {mma}")
    simt = {n: c for n, c in {**hmma, **k4_hmma}.items()
            if "_bf16_mma" not in n and c}
    check(not simt, f"the f32 flash kernels or K4 use tensor cores: {simt}")
    record["sass_hmma"] = {**hmma, **k4_hmma}


# -- phase 2 ------------------------------------------------------------------

def _pool_case(name: str, K: int, gen, dev, dh: int = 64,
               bs: int = SERVE_BLOCK, layout: str = "layer",
               pos0: bool = False):
    """The serving pool's shapes: [L=4, 129 blocks, 8 heads, 16, 64], one
    layer's view handed to the kernel as the engine does; 8 slots with
    ragged tables (trash 0 past each slot's position), one slot routed
    to the trash like a non-decoding slot. The options make K4's edge
    cases: another head dim or block size (8 x 256 / bs + 1 blocks);
    ``layout`` "block-major" (the pool stored [blocks, L, ...], so the
    layer's view strides its block axis past the other layers) or
    "misaligned" (rows of dh + 1, the view starting one element in, too
    narrow an alignment for the vector loads); ``pos0``: slot 1 at
    position 0 with a real table entry."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _quantize_rows,
    )
    L, H, S = 4, 8, SERVE_SLOTS
    NB = 256 // bs
    nblk = S * NB + 1
    wide = dh + 1 if layout == "misaligned" else dh
    kc = torch.randn((L, nblk, H, bs, wide), generator=gen)
    vc = torch.randn((L, nblk, H, bs, wide), generator=gen)
    if name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        (kd, ks), (vd, vs) = _quantize_rows(kc, name), _quantize_rows(vc, name)
    else:
        kd, vd = kc.to(getattr(torch, name)), vc.to(getattr(torch, name))
        ks = vs = None
    pos = torch.randint(0, 256, (S,), generator=gen)
    pos[0], pos[S - 1] = 255, 0
    if pos0:
        pos[1] = 0
    qpos = torch.clamp(pos[:, None] + torch.arange(K)[None, :], max=255)
    perm = torch.randperm(nblk - 1, generator=gen) + 1
    tables = torch.zeros((S, NB), dtype=torch.int32)
    for s in range(S - 1):
        n = int(qpos[s, -1]) // bs + 1
        tables[s, :n] = perm[s * NB:s * NB + n]
    q = torch.randn((S, H, K, dh), generator=gen)
    li = 2

    def layer(t, rows=True):
        """Layer li's view of a pool on the card (``rows``: values, whose
        last axis is sliced to dh on the card, not scales)."""
        if t is None:
            return None
        if layout == "block-major":
            return t.transpose(0, 1).contiguous().to(dev)[:, li]
        t = t.to(dev)[li]
        return t[..., wide - dh:] if rows else t

    return dict(q=q.to(dev), kc=layer(kd), vc=layer(vd),
                tables=tables.to(dev),
                qpos=qpos.to(torch.int32).contiguous().to(dev),
                kscale=layer(ks, False), vscale=layer(vs, False), bs=bs,
                kc32=layer(kc), vc32=layer(vc))


def _against_plain(name: str, c: dict) -> tuple[dict, bool, bool]:
    """K4 on one case against its plain version (``SAME_BYTES_TOL``) and
    against the unquantised f32 pool's answer (``ATTN_TOL``)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
    kw = dict(block_size=c["bs"], kscale=c["kscale"], vscale=c["vscale"])
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args, **kw)
    err = (out - ref).abs()
    rtol, atol = SAME_BYTES_TOL
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= atol + rtol * ref.abs()).all())
    wide = paged_attention_reference(c["q"], c["kc32"], c["vc32"],
                                     c["tables"], c["qpos"],
                                     block_size=c["bs"])
    werr = (out - wide).abs()
    wrtol, watol = ATTN_TOL[name]
    wide_ok = bool((werr <= watol + wrtol * wide.abs()).all())
    v = dict(dtype=name, K=int(c["q"].shape[2]), dh=int(c["q"].shape[3]),
             bs=c["bs"], max_abs_err=float(err.max()),
             max_rel_err=float((err / ref.abs().clamp_min(1e-6)).max()),
             rtol=rtol, atol=atol, max_abs_err_vs_f32=float(werr.max()),
             rtol_vs_f32=wrtol, atol_vs_f32=watol)
    return v, ok, wide_ok


def _bound(case: dict) -> tuple[float, str]:
    """Least time for this call's work: the larger of (bytes it must move)
    / HBM rate and (f32 operations it must do) / f32 rate. Bytes: the K/V
    rows up to each slot's newest position (and their scales) read once,
    q, tables entries, qpos read once, out written once."""
    S, H, K, dh = case["q"].shape
    qpos = case["qpos"].cpu()
    item = case["kc"].element_size()
    rows = int((qpos[:, -1] + 1).sum())
    n_kb = int(((qpos[:, -1] // case["bs"]) + 1).sum())
    nbytes = 2 * rows * H * dh * item + 4 * S * H * K * dh * 2
    nbytes += 4 * n_kb + 4 * S * K
    if case["kscale"] is not None:
        nbytes += 2 * rows * H * 4
    live = int((qpos + 1).sum())          # (query, key) pairs per head
    flops = 4 * live * H * dh             # q.k and p.v, 2 flops per MAC
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(record: dict) -> dict:
    import torch
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
        paged_attention_reference,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    variants = []
    for name in ATTN_TOL:
        for K in (1, 4):
            c = _pool_case(name, K, gen, dev)
            args = (c["q"], c["kc"], c["vc"], c["tables"], c["qpos"])
            kw = dict(block_size=c["bs"], kscale=c["kscale"],
                      vscale=c["vscale"])

            def kernel():
                return paged_attention(*args, **kw)

            def plain():
                return paged_attention_reference(*args, **kw)

            v, ok, wide_ok = _against_plain(name, c)
            max_abs, max_rel = v["max_abs_err"], v["max_rel_err"]
            rtol, atol = v["rtol"], v["atol"]
            wrtol = v["rtol_vs_f32"]
            bound_ms, bound_by = _bound(c)
            v.update(ms=time_ms(kernel, flush),
                     plain_ms=time_ms(plain, flush), bound_ms=bound_ms,
                     bound_by=bound_by)
            if name == "float32" and K == 1:
                v["profiler_ms"] = profiled_kernel_ms(kernel, flush,
                                                      "paged_attn_kernel")
            variants.append(v)
            xcheck = (f" (profiler {v['profiler_ms']:.4f} ms)"
                      if "profiler_ms" in v else "")
            print(f"chip_smoke: paged_attention {name:>13} K={K}: vs plain "
                  f"max abs {max_abs:.3e} rel {max_rel:.3e} (limits rtol "
                  f"{rtol} atol {atol}) {'ok' if ok else 'FAIL'}; vs the f32 "
                  f"pool max abs {v['max_abs_err_vs_f32']:.3e} (attn_tol "
                  f"{wrtol}) {'ok' if wide_ok else 'FAIL'}; kernel "
                  f"{v['ms']:.4f} ms{xcheck}, plain {v['plain_ms']:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            check(ok, f"paged_attention {name} K={K} disagrees with its "
                      f"plain version: max abs {max_abs}")
            check(wide_ok, f"paged_attention {name} K={K} is outside "
                           f"attn_tol of the f32 pool's answer: max abs "
                           f"{v['max_abs_err_vs_f32']}")
    main = next(v for v in variants
                if v["dtype"] == "float32" and v["K"] == 1)
    print(f"chip_smoke: paged_attention float32 K=1: kernel "
          f"{main['ms']:.4f} ms against its plain version "
          f"{main['plain_ms']:.4f} ms: {main['plain_ms'] / main['ms']:.2f}x "
          f"faster")
    check(main["ms"] < main["plain_ms"], "K4 is no faster than its plain "
                                         "version at the f32 K = 1 case")
    edges = []
    for name, K, opts in K4_EDGES:
        c = _pool_case(name, K, gen, dev, pos0=True, **opts)
        v, ok, wide_ok = _against_plain(name, c)
        v["case"] = opts
        edges.append(v)
        print(f"chip_smoke: paged_attention edge {name:>13} K={K} {opts}: "
              f"vs plain max abs {v['max_abs_err']:.3e} "
              f"{'ok' if ok else 'FAIL'}; vs the f32 pool max abs "
              f"{v['max_abs_err_vs_f32']:.3e} {'ok' if wide_ok else 'FAIL'}")
        check(ok and wide_ok, f"paged_attention edge case {name} K={K} "
                              f"{opts} disagrees: {v}")
    print("chip_smoke: paged_attention library_ms: none — no single "
          "PyTorch call computes block-table-gathered attention "
          "(scaled_dot_product_attention needs the rows gathered first)")
    record["kernel_variants"] = variants
    record["kernel_edges"] = edges
    return variants + edges


def _flash_bound(name: str, shape, dtype) -> tuple[float, str]:
    """Least time for one flash kernel's work at ``shape`` [B, H, T, dh]:
    the larger of (bytes: each [B, H, T, dh] operand read once, each output
    written once, f32 row statistics) / HBM rate and (the causal products'
    operations: 2 per multiply-add over the T(T+1)/2 live pairs per head;
    K1 does q.k and p.v, K2 adds do.v and ds.k, K3 q.k, do.v, p.do and
    ds.q) / the peak rate of the input type (bf16 tensor cores; f32 outside
    them, since TF32 is off)."""
    B, H, T, dh = shape
    e = 2 if dtype == "bfloat16" else 4
    slab, rows = B * H * T * dh * e, B * H * T * 4
    nbytes, products = {
        "flash_forward": (3 * slab + slab + 2 * rows, 2),
        "flash_dq": (4 * slab + 3 * rows + slab, 3),
        "flash_dkv": (4 * slab + 3 * rows + 2 * slab, 4),
    }[name]
    flops = products * 2 * B * H * (T * (T + 1) // 2) * dh
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_inputs(shape, dtype, gen, dev):
    import torch
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, getattr(
        torch, dtype)) for _ in range(4))
    return q, k, v, do


def _flash_err(out, ref, rtol: float, atol: float) -> tuple[float, bool]:
    import torch
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= atol + rtol * ref.abs()).all())
    return float(err.max()), ok


def phase_flash_kernels(record: dict) -> list[dict]:
    """K1, K2 and K3 against their plain versions on the card, for f32 and
    bf16, at the full-width training shape and at a ragged T = 200 (the
    masked tail live), plus the tiny ``gpt`` row's f32 shape and the bf16
    edge shapes ``FLASH_EDGES`` of the tensor-core K1-K3. K2 and K3 are
    fed the plain forward's statistics, so each is held alone. Each kernel
    is timed (as phase 2 times K4) at the shape its bench row gives it,
    beside its plain version, its bound and the library yardstick:
    ``scaled_dot_product_attention`` for K1, and SDPA's backward (forward
    and ``autograd.grad`` less the forward) for K2 + K3 together."""
    import torch
    import torch.nn.functional as F
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    cases = [("bfloat16", FLASH_SHAPE), ("bfloat16", FLASH_RAGGED),
             ("float32", FLASH_SHAPE), ("float32", FLASH_RAGGED),
             ("float32", FLASH_TINY_SHAPE)]
    cases += [("bfloat16", shape) for shape in FLASH_EDGES]
    timed = {("bfloat16", FLASH_SHAPE), ("float32", FLASH_TINY_SHAPE)}
    out = []
    for dtype, shape in cases:
        q, k, v, do = _flash_inputs(shape, dtype, gen, dev)
        o_ref, l_ref, m_ref = fa.flash_forward_reference(q, k, v)
        linv, delta = fa._backward_stats(o_ref, l_ref, do)
        bwd = (q, k, v, do, m_ref, linv, delta)
        runs = {
            "flash_forward": (lambda: fa.flash_forward(q, k, v),
                              lambda: fa.flash_forward_reference(q, k, v)),
            "flash_dq": (lambda: fa.flash_dq(*bwd),
                         lambda: fa.flash_dq_reference(*bwd)),
            "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                          lambda: fa.flash_dkv_reference(*bwd)),
        }
        lib = {}
        if (dtype, shape) in timed:
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg,
                                                      is_causal=True)

            def sdpa_fb():
                return torch.autograd.grad(sdpa(), (qg, kg, vg), do)

            fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush)
            lib = {"flash_forward": fwd_ms,
                   "backward": time_ms(sdpa_fb, flush) - fwd_ms}
        for name, (kernel, plain) in runs.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            parts = {"flash_forward": ("o", "l", "m"), "flash_dq": ("dq",),
                     "flash_dkv": ("dk", "dv")}[name]
            errs, ok = {}, True
            for part, g, r in zip(parts, got, ref):
                rtol, atol = FLASH_TOL[(dtype, part in ("l", "m"),
                                        name != "flash_forward")]
                errs[part], part_ok = _flash_err(g, r, rtol, atol)
                ok = ok and part_ok
            v_ = dict(name=name, dtype=dtype, shape=list(shape),
                      max_abs_err=max(errs.values()), errs=errs)
            line = (f"chip_smoke: {name:13} {dtype:>8} {tuple(shape)}: vs "
                    f"plain max abs " + ", ".join(
                        f"{p} {e:.3e}" for p, e in errs.items())
                    + f" {'ok' if ok else 'FAIL'}")
            if lib:
                v_["ms"] = time_ms(kernel, flush)
                v_["plain_ms"] = time_ms(plain, flush)
                v_["bound_ms"], v_["bound_by"] = _flash_bound(name, shape,
                                                              dtype)
                v_["library_ms"] = lib.get(name, lib["backward"])
                line += (f"; kernel {v_['ms']:.4f} ms, plain "
                         f"{v_['plain_ms']:.4f} ms, bound "
                         f"{v_['bound_ms']:.4f} ms ({v_['bound_by']}), "
                         f"library {v_['library_ms']:.4f} ms")
            print(line)
            check(ok, f"{name} {dtype} {tuple(shape)} disagrees with its "
                      f"plain version: {errs}")
            out.append(v_)
    main = {v["name"]: v for v in out if v["dtype"] == "bfloat16"
            and tuple(v["shape"]) == FLASH_SHAPE}
    fwd = main["flash_forward"]
    print(f"chip_smoke: K1 bf16 {FLASH_SHAPE}: {fwd['ms']:.4f} ms against "
          f"SDPA's forward {fwd['library_ms']:.4f} ms: "
          f"{fwd['ms'] / fwd['library_ms']:.2f}x")
    record["flash_forward_vs_sdpa"] = dict(
        k1_ms=fwd["ms"], sdpa_forward_ms=fwd["library_ms"],
        ratio=fwd["ms"] / fwd["library_ms"])
    bwd_ms = main["flash_dq"]["ms"] + main["flash_dkv"]["ms"]
    sdpa_bwd = main["flash_dq"]["library_ms"]
    print(f"chip_smoke: K2 + K3 bf16 {FLASH_SHAPE}: {bwd_ms:.4f} ms against "
          f"SDPA's backward {sdpa_bwd:.4f} ms: {bwd_ms / sdpa_bwd:.2f}x")
    record["flash_backward_vs_sdpa"] = dict(k2_k3_ms=bwd_ms,
                                            sdpa_backward_ms=sdpa_bwd,
                                            ratio=bwd_ms / sdpa_bwd)
    print("chip_smoke: flash library_ms: K1's is "
          "scaled_dot_product_attention(is_causal=True); K2's and K3's are "
          "both SDPA's whole backward (forward + autograd.grad, less the "
          "forward): one call computes dq, dk and dv together")
    record["flash_variants"] = out
    return out


# -- phase 3 ------------------------------------------------------------------

def _serve(stages, cfg, kernel: str):
    import numpy as np
    from simple_distributed_machine_learning_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        ServeMetrics,
        SimConfig,
        simulate,
    )
    engine = InferenceEngine(stages, cfg, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel=kernel)
    # warm every shape outside the measured trace (bench.py's warm-up):
    # one small request per prompt-length bucket, plus decode ticks
    for t0 in SERVE_SIM["prompt_lens"]:
        engine.submit(np.zeros(t0, np.int32), max_new_tokens=2)
    engine.drain()
    engine.metrics = metrics = ServeMetrics()
    decode_calls = [0]
    decode = engine._decode

    def counted(*a):
        decode_calls[0] += 1
        return decode(*a)

    engine._decode = counted
    first_rid = engine._next_rid
    paged_attention.launches = 0
    rep = simulate(engine, SimConfig(**SERVE_SIM))
    launches = paged_attention.launches
    handles = [engine.requests[first_rid + i]
               for i in range(SERVE_SIM["n_requests"])]
    return rep, metrics.summary(), handles, launches, decode_calls[0]


def phase_serve(stages, cfg, record: dict) -> dict:
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        make_cached_decoder,
    )
    from simple_distributed_machine_learning_tpu_torch.ops.random import (
        key_data,
    )
    n_params = sum(p.numel() for p in stages[0].params.parameters())
    rep, s, handles, launches, ticks = _serve(stages, cfg, "fused")
    print(f"chip_smoke: serve fused: {rep['completed']}/{rep['n_requests']} "
          f"requests, {s['tokens_generated']} tokens, "
          f"{s['tokens_per_sec']} tok/s, ttft p50/p95 {s['ttft_ms_p50']}/"
          f"{s['ttft_ms_p95']} ms, tpot p50/p95 {s['tpot_ms_p50']}/"
          f"{s['tpot_ms_p95']} ms, occupancy {s['slot_occupancy_mean']}, "
          f"{s['prefix_hit_blocks']} prefix hits, {s['cow_copies']} CoW; "
          f"{n_params} params on {torch.cuda.get_device_name(0)}")
    check(rep["completed"] == SERVE_SIM["n_requests"],
          f"only {rep['completed']}/{rep['n_requests']} requests completed")
    print(f"chip_smoke: paged_attention launches {launches} = "
          f"{cfg.n_layers} layers x {ticks} decode ticks: "
          f"{launches == cfg.n_layers * ticks}")
    check(ticks > 0 and launches == cfg.n_layers * ticks,
          f"kernel launches {launches} != {cfg.n_layers} x {ticks} ticks")
    drep, ds, dhandles, dlaunches, _ = _serve(stages, cfg, "dense")
    check(drep["completed"] == SERVE_SIM["n_requests"] and dlaunches == 0,
          "the dense engine did not complete (or launched the kernel)")
    print(f"chip_smoke: serve dense: {ds['tokens_per_sec']} tok/s, tpot "
          f"p50/p95 {ds['tpot_ms_p50']}/{ds['tpot_ms_p95']} ms")
    greedy = [i for i, h in enumerate(handles) if h.temperature == 0.0]
    same_dense = [i for i in greedy
                  if handles[i].tokens == dhandles[i].tokens]
    params = [st.params for st in stages]
    same_solo = []
    for i in greedy:
        h = handles[i]
        t0 = int(h.prompt.shape[0])
        solo = make_cached_decoder(stages, cfg, t0, h.max_new_tokens)(
            params, h.prompt[None], key_data(h.seed))
        if solo[0, t0:].tolist() == h.tokens:
            same_solo.append(i)
    distinct = len({t for i in greedy for t in handles[i].tokens})
    print(f"chip_smoke: greedy streams equal to the dense engine's "
          f"{len(same_dense)}/{len(greedy)}, to the solo decoder's "
          f"{len(same_solo)}/{len(greedy)} ({distinct} distinct tokens)")
    check(len(greedy) >= 2 and len(same_dense) == len(greedy)
          and len(same_solo) == len(greedy),
          "greedy streams through the kernel differ from the dense path's "
          "or the solo decoder's")
    serve = dict(summary=s, dense_summary=ds, launches=launches,
                 decode_ticks=ticks, greedy=len(greedy),
                 greedy_equal_dense=len(same_dense),
                 greedy_equal_solo=len(same_solo), n_params=n_params,
                 wall_s=rep["wall_s"], dense_wall_s=drep["wall_s"])
    record["serve"] = serve
    return serve


def phase_profile(stages, cfg, record: dict, n_ticks: int = 20) -> None:
    """A steady decode window at full occupancy (8 slots,
    32-token prompts): ``n_ticks`` ticks timed on the host clock, then
    ``n_ticks`` more under ``torch.profiler`` for the device's busy share
    and its time by kernel (Chrome trace in ``chiprun_out/``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
    )
    engine = InferenceEngine(stages, cfg, n_slots=SERVE_SLOTS,
                             block_size=SERVE_BLOCK, attn_kernel="fused")
    rng = np.random.default_rng(1)
    for _ in range(SERVE_SLOTS):
        engine.submit(rng.integers(0, cfg.vocab, 32).astype(np.int32),
                      max_new_tokens=2 * n_ticks + 8)
    while engine._prefilling:
        engine.step()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        engine.step()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(len(engine._decoding_slots()) == SERVE_SLOTS,
          "the profiled window did not run at full occupancy")
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        kernels.append((float(t), e.count, e.key))
    busy_us = sum(t for t, _, _ in kernels)
    check(busy_us > 0, "torch.profiler recorded no device time")
    kernels.sort(reverse=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "serve_profile.json"))
    prof_rec = dict(tick_ms=tick_ms, profiled_tick_ms=wall_us / 1e3 / n_ticks,
                    device_busy_share=busy_us / wall_us,
                    kernel_launches_per_tick=sum(c for _, c, _ in kernels)
                    / n_ticks,
                    top=[dict(name=k[:120], us_per_tick=t / n_ticks,
                              calls_per_tick=c / n_ticks)
                         for t, c, k in kernels[:10]])
    record["profile"] = prof_rec
    print(f"chip_smoke: profile: decode tick at 8/8 slots {tick_ms:.3f} ms "
          f"(host clock, unprofiled); under the profiler "
          f"{prof_rec['profiled_tick_ms']:.3f} ms, device busy "
          f"{prof_rec['device_busy_share']:.4f}, "
          f"{prof_rec['kernel_launches_per_tick']:.1f} kernels/tick")
    for k in prof_rec["top"]:
        print(f"chip_smoke:   {k['us_per_tick']:9.2f} us/tick "
              f"{k['calls_per_tick']:6.1f} calls  {k['name']}")


# -- phases 5-6: training ------------------------------------------------------

def _flash_counts() -> tuple[int, int, int]:
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    return (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches)


def _reset_flash_counts() -> None:
    from simple_distributed_machine_learning_tpu_torch.ops import (
        flash_attention as fa,
    )
    fa.flash_forward.launches = fa.flash_dq.launches = 0
    fa.flash_dkv.launches = 0


def _train_setup(row: dict, attn_impl: str):
    """The bench row's model (random weights from seed 0), pipeline,
    optimizer and a pool of 2 random token batches (float ids, as
    ``bench.py::_data_gpt`` makes them)."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        adamw,
        sgd,
    )
    cfg = GPTConfig(**row["cfg"], attn_impl=attn_impl)
    stages, wire_dim, out_dim = make_gpt_stages(0, cfg, 1)
    pipe = Pipeline(stages, None, wire_dim, out_dim,
                    n_microbatches=row["n_micro"],
                    compute_dtype=row["dtype"] and getattr(torch,
                                                           row["dtype"]))
    opt = (adamw(1e-3) if row["opt"] == "adamw"
           else sgd(0.1, momentum=0.5))
    gen = torch.Generator().manual_seed(1)
    shape = (TRAIN_POOL, row["batch"], cfg.seq_len)
    xs = torch.randint(0, cfg.vocab, shape, generator=gen).float()
    ts = torch.randint(0, cfg.vocab, shape, generator=gen)
    return cfg, pipe, opt, xs.to(pipe.device), ts.to(pipe.device)


def _train_window(pipe, opt, xs, ts, steps: int):
    """``steps`` optimizer steps from fresh weights through
    ``make_scanned_train_step`` over the pool; host-clock seconds to the
    synchronised end, and the per-step losses."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_scanned_train_step,
    )
    params = pipe.init_params()
    state = opt.init(params)
    step = make_scanned_train_step(pipe, opt, pool_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, losses = step(params, state, xs, ts, 0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, losses.cpu().tolist()


def _leaky_core(q, k, v):
    """A known-wrong attention core: the dense one with the causal mask one
    key too wide, so each query also sees its successor."""
    import math

    import torch
    t = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril(1)
    p = torch.softmax(torch.where(keep, s, -math.inf), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _wrong_attention_window(dpipe, dopt, xs, ts) -> list[float]:
    """The flash-vs-dense gate's negative control: the dense pipeline's
    ``TRAIN_COMPARE_STEPS`` steps with :func:`_leaky_core` in place of the
    model's attention core; the per-step losses."""
    from simple_distributed_machine_learning_tpu_torch.models import (
        gpt as gpt_mod,
    )
    core = gpt_mod.causal_attention_core
    gpt_mod.causal_attention_core = _leaky_core
    try:
        return _train_window(dpipe, dopt, xs, ts, TRAIN_COMPARE_STEPS)[1]
    finally:
        gpt_mod.causal_attention_core = core


def phase_train(name: str, row: dict, record: dict) -> dict:
    """One bench row's training on the port's main path: ``Pipeline`` +
    ``make_scanned_train_step`` with ``attn_impl="flash"`` for
    ``TRAIN_STEPS`` steps (after a 2-step warm-up window), then the same
    weights and batches with ``attn_impl="dense"`` for
    ``TRAIN_COMPARE_STEPS`` steps, and with a known-wrong attention core.
    Checks: finite losses whose last-5 mean is below the first; K1, K2 and
    K3 launched exactly ``n_layers`` times per step each (counts set to 0
    just before the flash run, read just after), and never by the dense
    run; flash and dense losses within the row's limit over the compared
    steps, and the wrong run's losses outside it."""
    import math

    import torch
    cfg, pipe, opt, xs, ts = _train_setup(row, "flash")
    _train_window(pipe, opt, xs, ts, 2)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    wall_s, losses = _train_window(pipe, opt, xs, ts, TRAIN_STEPS)
    counts = _flash_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_params = sum(p.numel() for p in pipe.stages[0].params.parameters())
    step_ms = wall_s * 1e3 / TRAIN_STEPS
    tokens = row["batch"] * cfg.seq_len
    print(f"chip_smoke: train {name} (flash, {row['dtype'] or 'float32'}, "
          f"{row['opt']}, batch {row['batch']}, {n_params} params): "
          f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"step {step_ms:.3f} ms (host clock), "
          f"{row['batch'] * 1e3 / step_ms:.1f} samples/s, "
          f"{tokens * 1e3 / step_ms:.0f} tokens/s, peak {peak_mb:.0f} MiB")
    check(all(math.isfinite(v) for v in losses),
          f"{name}: non-finite training loss {losses}")
    last5 = sum(losses[-5:]) / 5
    check(last5 < losses[0], f"{name}: the loss did not fall (first "
                             f"{losses[0]}, mean of the last 5 {last5})")
    want = cfg.n_layers * TRAIN_STEPS
    print(f"chip_smoke: {name} launches K1/K2/K3 {counts} = {cfg.n_layers} "
          f"layers x {TRAIN_STEPS} steps: {counts == (want,) * 3}")
    check(counts == (want,) * 3, f"{name}: flash launches {counts} != "
                                 f"{cfg.n_layers} x {TRAIN_STEPS} each")
    _, dpipe, dopt, _, _ = _train_setup(row, "dense")
    _reset_flash_counts()
    _, dlosses = _train_window(dpipe, dopt, xs, ts, TRAIN_COMPARE_STEPS)
    check(_flash_counts() == (0, 0, 0), f"{name}: the dense run launched "
                                        f"a flash kernel")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, dlosses))
    wlosses = _wrong_attention_window(dpipe, dopt, xs, ts)
    wrong = max(abs(a - b) / abs(b) for a, b in zip(wlosses, dlosses))
    limit = row["flash_vs_dense_rtol"]
    print(f"chip_smoke: {name} flash vs dense losses over "
          f"{TRAIN_COMPARE_STEPS} steps: max rel diff {rel:.3e} (limit "
          f"{limit}) {'ok' if rel <= limit else 'FAIL'}; a causal mask one "
          f"key too wide vs dense: {wrong:.3e} "
          f"{'caught' if wrong > limit else 'MISSED'}")
    check(rel <= limit, f"{name}: flash and dense losses differ by {rel} "
                        f"relative (limit {limit})")
    check(wrong > limit, f"{name}: the limit {limit} does not tell a wrong "
                         f"attention path (gap {wrong}) from a sound one")
    out = dict(steps=TRAIN_STEPS, losses=losses,
               dense_losses=dlosses, flash_vs_dense_max_rel=rel,
               wrong_attention_losses=wlosses,
               wrong_vs_dense_max_rel=wrong,
               flash_vs_dense_rtol=limit, step_ms=step_ms,
               samples_per_s=row["batch"] * 1e3 / step_ms,
               tokens_per_s=tokens * 1e3 / step_ms, launches=counts,
               peak_mib=peak_mb, n_params=n_params)
    record.setdefault("train", {})[name] = out
    return out


def phase_train_profile(row: dict, record: dict, n_steps: int = 5) -> None:
    """Where a full-width flash training step's time goes: ``n_steps``
    ``make_train_step`` calls under ``torch.profiler`` after a warm-up —
    the device's busy share, kernel launches per step and device time by
    kernel (Chrome trace in ``chiprun_out/``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
    )
    cfg, pipe, opt, xs, ts = _train_setup(row, "flash")
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    for i in range(3):
        params, state, _ = step(params, state, xs[i % TRAIN_POOL],
                                ts[i % TRAIN_POOL])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            params, state, _ = step(params, state, xs[i % TRAIN_POOL],
                                    ts[i % TRAIN_POOL])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        kernels.append((float(t), e.count, e.key))
    busy_us = sum(t for t, _, _ in kernels)
    check(busy_us > 0, "torch.profiler recorded no device time")
    flash = {}                      # K1, K2, K3: (us per step, launches)
    for kern in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        hits = [(t, c) for t, c, k in kernels if kern in k]
        check(bool(hits), f"the profiled step shows no {kern}")
        flash[kern] = (sum(t for t, _ in hits) / n_steps,
                       sum(c for _, c in hits) / n_steps)
    # the bf16 K1 runs the tensor-core kernel, once per layer per step
    k1_mma = sum(c for _, c, k in kernels
                 if "flash_fwd_kernel_bf16_mma" in k) / n_steps
    print(f"chip_smoke:   flash_fwd_kernel_bf16_mma launches per step "
          f"{k1_mma:.1f} (n_layers {cfg.n_layers})")
    check(k1_mma == cfg.n_layers, f"the profiled step launched "
                                  f"flash_fwd_kernel_bf16_mma {k1_mma} "
                                  f"times per step, not {cfg.n_layers}")
    kernels.sort(reverse=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_profile.json"))
    flash_us = sum(t for t, _, k in kernels if "flash_" in k)
    prof_rec = dict(profiled_step_ms=wall_us / 1e3 / n_steps,
                    device_busy_share=busy_us / wall_us,
                    device_ms_per_step=busy_us / 1e3 / n_steps,
                    flash_kernels_ms_per_step=flash_us / 1e3 / n_steps,
                    kernel_launches_per_step=sum(c for _, c, _ in kernels)
                    / n_steps,
                    flash_us_per_step={k: v[0] for k, v in flash.items()},
                    top=[dict(name=k[:120], us_per_step=t / n_steps,
                              calls_per_step=c / n_steps)
                         for t, c, k in kernels[:12]])
    record["train_profile"] = prof_rec
    print(f"chip_smoke: profile: gpt_bf16 flash train step under the "
          f"profiler {prof_rec['profiled_step_ms']:.3f} ms, device busy "
          f"{prof_rec['device_busy_share']:.4f} "
          f"({prof_rec['device_ms_per_step']:.3f} ms/step, flash kernels "
          f"{prof_rec['flash_kernels_ms_per_step']:.3f} ms), "
          f"{prof_rec['kernel_launches_per_step']:.1f} kernels/step")
    print("chip_smoke:   flash kernels per step: " + ", ".join(
        f"{kern} {us:.2f} us ({n:.1f} calls)"
        for kern, (us, n) in flash.items()))
    for k in prof_rec["top"]:
        print(f"chip_smoke:   {k['us_per_step']:9.2f} us/step "
              f"{k['calls_per_step']:6.1f} calls  {k['name']}")


# -- phase 7: the reference's main path ----------------------------------------

def _quiet(fn, *args):
    """``fn(*args)`` with its console captured: ``(result, text)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _cli(argv: list[str]) -> list[str]:
    """``cli.main(argv)`` in this process on ``MAIN_DEVICE``; its console
    lines, blank ones dropped."""
    from simple_distributed_machine_learning_tpu_torch.cli import main as cli
    text = _quiet(cli, ["--rank", "0", "--world_size", "1", "--device",
                        MAIN_DEVICE] + argv)[1]
    return [line for line in text.split("\n") if line]


def _main_rows() -> dict:
    """``bench.py::_configs``'s lenet, mlp2 and mlp4 rows: each builder
    (random weights from seed 0, one stage on the card) and whether its
    input is the image or the flattened image."""
    from simple_distributed_machine_learning_tpu_torch.models import (
        make_lenet_stages,
        make_mlp_stages,
    )
    return {"lenet": (lambda dev: make_lenet_stages(0, 1, dev), False),
            "mlp2": (lambda dev: make_mlp_stages(0, MLP2, 1, dev), True),
            "mlp4": (lambda dev: make_mlp_stages(0, MLP4, 1, dev), True)}


def _row_data(flat: bool):
    """The reference's data as the CLI loads it without MNIST files: the
    synthetic set at 6000/1000 samples."""
    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        Dataset,
        synthetic_mnist,
    )
    train, test = synthetic_mnist(n_train=6000, n_test=1000)
    if flat:
        train = Dataset(train.x.reshape(len(train.x), -1), train.y)
        test = Dataset(test.x.reshape(len(test.x), -1), test.y)
    return train, test


def _trainer(row: str, device, epochs: int, ckpt_dir: str | None):
    """A reference-configured ``Trainer`` (batch 60, SGD lr 0.1 momentum
    0.5) on one of ``_main_rows``; its console goes nowhere."""
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )
    build, flat = _main_rows()[row]
    stages, wire_dim, out_dim = build(device)
    train, test = _row_data(flat)
    cfg = TrainConfig(epochs=epochs, checkpoint_dir=ckpt_dir,
                      print_throughput=False)
    return Trainer(Pipeline(stages, None, wire_dim, out_dim, device=device),
                   train, test, cfg)


def _sync() -> None:
    import torch
    if MAIN_DEVICE == "cuda":
        torch.cuda.synchronize()


def _resume_gap(row: str, tmp: str) -> tuple[float, int]:
    """Two epochs straight against one epoch, a checkpoint and a resumed
    second epoch, on the card: the largest relative difference of the
    final parameters and momentum (0.0 = bit-exact), and the accuracy of
    the straight run on the 1000 test samples."""
    straight = _trainer(row, MAIN_DEVICE, 2, None)
    _quiet(straight.fit)
    _, correct = _quiet(straight.evaluate)[0]
    ck = os.path.join(tmp, f"{row}_resume")
    _quiet(_trainer(row, MAIN_DEVICE, 1, ck).fit)
    resumed, log = _quiet(_trainer, row, MAIN_DEVICE, 2, ck)
    check("| resumed from" in log and resumed.start_epoch == 2,
          f"{row}: the second trainer did not resume: {log!r}")
    _quiet(resumed.fit)
    gap = 0.0
    pairs = (list(zip(straight.params[0].parameters(),
                      resumed.params[0].parameters()))
             + list(zip(straight.opt_state, resumed.opt_state)))
    for a, b in pairs:
        d = (a - b).abs().max().item()
        gap = max(gap, d / max(a.abs().max().item(), 1e-30))
    return gap, correct


def _lenet_steps(device, batches, conv_apply=None) -> list[float]:
    """``MAIN_COMPARE_STEPS`` deterministic SGD steps (lr 0.1, momentum
    0.5, dropout off) of the fused LeNet from seed 0's weights on
    ``device``; the per-step losses. ``conv_apply`` replaces the conv
    stage (the known-wrong twin)."""
    import dataclasses

    from simple_distributed_machine_learning_tpu_torch.models import lenet
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import sgd
    stages, wire_dim, out_dim = lenet.make_lenet_stages(0, 1, device)
    if conv_apply is not None:
        def fused(params, x, key=None, deterministic=True):
            h = conv_apply(params["conv"], x, key, deterministic)
            return lenet._fc_apply(params["fc"], h, key, deterministic)
        stages = [dataclasses.replace(stages[0], apply=fused)]
    pipe = Pipeline(stages, None, wire_dim, out_dim, device=device)
    opt = sgd(0.1, 0.5)
    params = pipe.init_params()
    state = opt.init(params)
    losses = []
    for b in batches:
        loss, grads = pipe.loss_and_grads(params, b.x, b.y,
                                          deterministic=True)
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    return losses


def _chw_conv_apply(params, x, key=None, deterministic=True):
    """LeNet's conv stage flattened in torch's (C, H, W) order where the
    JAX layout flattens (H, W, C): fc1 reads the wrong features."""
    from simple_distributed_machine_learning_tpu_torch.models import lenet
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv1"], x), 2))
    h = lenet.relu(lenet.max_pool2d(lenet.conv2d(params["conv2"], h), 2))
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], lenet.FEATURES)


def _time_row(row: str) -> dict:
    """One row's training step at batch 60 on the card: ``make_train_step``
    (SGD lr 0.1, momentum 0.5) fed one pageable host -> device copy per
    batch as the Trainer feeds it. Host-clock ms per step over
    ``MAIN_TIMED_STEPS`` steps after ``MAIN_WARMUP_STEPS``, ending in a
    synchronise; then ``MAIN_PROFILED_STEPS`` steps under
    ``torch.profiler``: the device's busy share and device ms per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        batches,
    )
    from simple_distributed_machine_learning_tpu_torch.parallel import (
        Pipeline,
    )
    from simple_distributed_machine_learning_tpu_torch.train import (
        make_train_step,
        sgd,
    )
    build, flat = _main_rows()[row]
    stages, wire_dim, out_dim = build(MAIN_DEVICE)
    pipe = Pipeline(stages, None, wire_dim, out_dim, device=MAIN_DEVICE)
    opt = sgd(0.1, 0.5)
    params = pipe.init_params()
    state = opt.init(params)
    step = make_train_step(pipe, opt)
    feed = list(batches(_row_data(flat)[0], 60))
    n_params = sum(p.numel() for p in params[0].parameters())

    def run(i0: int, n: int):
        nonlocal params, state
        for i in range(i0, i0 + n):
            b = feed[i % len(feed)]
            params, state, _ = step(params, state, torch.from_numpy(b.x),
                                    torch.from_numpy(b.y), i)

    run(0, MAIN_WARMUP_STEPS)
    _sync()
    t0 = time.perf_counter()
    run(MAIN_WARMUP_STEPS, MAIN_TIMED_STEPS)
    _sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / MAIN_TIMED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, MAIN_PROFILED_STEPS)
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, launches, host = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += float(getattr(e, "self_device_time_total", None)
                             or getattr(e, "self_cuda_time_total", 0))
            launches += e.count
        else:
            host.append((float(e.self_cpu_time_total), e.count, e.key))
    check(busy_us > 0, f"{row}: torch.profiler recorded no device time")
    n = MAIN_PROFILED_STEPS
    out = dict(batch=60, n_params=n_params, step_ms=step_ms,
               samples_per_s=60e3 / step_ms,
               profiled_step_ms=wall_us / 1e3 / n,
               device_ms_per_step=busy_us / 1e3 / n,
               device_busy_share=busy_us / wall_us,
               device_ops_per_step=launches / n,
               host_ops_ms_per_step=sum(t for t, _, _ in host) / 1e3 / n)
    check(all(np.isfinite(v) for v in out.values()),
          f"{row}: non-finite timing {out}")
    out["host_top"] = [dict(name=k[:80], us_per_step=t / n,
                            calls_per_step=c / n)
                       for t, c, k in sorted(host, reverse=True)[:8]]
    return out


def phase_main_path(record: dict) -> None:
    """The reference's main path on the card, through the port's CLI and
    Trainer: the LeNet CLI run with checkpoints, metrics and a resume; the
    LeNet trajectory on the card against the port's CPU path, with a
    known-wrong twin outside the limit; ``mlp2`` learning and its resume
    bit-exact; ``gpt --attn flash`` through the CLI with exactly
    ``n_layers`` launches of K1, K2 and K3 per step; and the step times of
    the lenet, mlp2 and mlp4 rows."""
    import math
    import re
    import tempfile

    from simple_distributed_machine_learning_tpu_torch.data.mnist import (
        batches,
    )
    rec: dict = {}
    record["main_path"] = rec
    with tempfile.TemporaryDirectory() as tmp:
        ck, metrics = os.path.join(tmp, "lenet"), os.path.join(tmp, "m.jsonl")
        argv = ["--model", "lenet", "--data-root",
                os.path.join(tmp, "no-mnist"), "--checkpoint-dir", ck,
                "--metrics-json", metrics]
        t0 = time.perf_counter()
        lines = _cli(argv + ["--epochs", "2"])
        cli_s = time.perf_counter() - t0
        bad = [ln for ln in lines if not (TRAIN_RE.match(ln) or
                                          TEST_RE.match(ln) or
                                          EPOCH_RE.match(ln))]
        check(not bad, f"lenet CLI: lines off the reference formats: {bad}")
        losses = [float(TRAIN_RE.match(ln).group(5)) for ln in lines
                  if TRAIN_RE.match(ln)]
        check(len(losses) == 20 and all(math.isfinite(v) for v in losses),
              f"lenet CLI: expected 20 finite loss lines, got {losses}")
        with open(metrics) as f:
            recs = [json.loads(ln) for ln in f]
        check(len(recs) == 2 and all(r["schema"] == 2 for r in recs),
              f"lenet CLI: expected 2 schema-2 records, got {recs}")
        again = _cli(argv + ["--epochs", "3"])
        want = f"| resumed from {ck}/state.npz at epoch 3 (step 200)"
        check(again[0] == want and any(ln.startswith("Train Epoch: 3 [")
                                       for ln in again),
              f"lenet CLI rerun: expected {want!r} then epoch 3, got "
              f"{again[:3]}")
        rec["lenet_cli"] = dict(
            seconds=cli_s, console=lines, resumed=again,
            samples_per_s=[float(EPOCH_RE.match(ln).group(2))
                           for ln in lines if EPOCH_RE.match(ln)],
            accuracy=[r["accuracy"] for r in recs])
        print(f"chip_smoke: main path: lenet CLI 2 epochs in {cli_s:.1f} s, "
              f"losses {losses[0]} -> {losses[-1]}, "
              f"{[ln for ln in lines if EPOCH_RE.match(ln)]}, test "
              f"accuracy {rec['lenet_cli']['accuracy']}; rerun: {again[0]}")

        # the trajectory on the card against the port's CPU path
        feed = list(batches(_row_data(False)[0], 60))[:MAIN_COMPARE_STEPS]
        cpu = _lenet_steps("cpu", feed)
        card = _lenet_steps(MAIN_DEVICE, feed)
        wrong = _lenet_steps(MAIN_DEVICE, feed, _chw_conv_apply)

        def worst(ls):
            return max(abs(a - b) / abs(b) / (1e-4 * (i + 1) + 1e-5)
                       for i, (a, b) in enumerate(zip(ls, cpu)))
        ok, caught = worst(card), worst(wrong)
        rec["lenet_card_vs_cpu"] = dict(cpu=cpu, card=card, wrong=wrong,
                                        worst_share_of_limit=ok,
                                        wrong_share_of_limit=caught)
        print(f"chip_smoke: main path: lenet {MAIN_COMPARE_STEPS} "
              f"deterministic SGD steps, card vs CPU: worst gap "
              f"{ok:.3f} of rel=1e-4*(i+1)+1e-5 "
              f"{'ok' if ok <= 1 else 'FAIL'}; a (C, H, W) flatten: "
              f"{caught:.1f} of it {'caught' if caught > 1 else 'MISSED'}")
        check(ok <= 1, f"lenet on the card left the CPU path's trajectory: "
                       f"{card} vs {cpu}")
        check(caught > 1, "the trajectory limit does not tell a (C, H, W) "
                          "flatten from the sound LeNet")

        # mlp2 learns, and resumes bit-exact; LeNet's resume gap
        for row in ("mlp2", "lenet"):
            gap, correct = _resume_gap(row, tmp)
            rec[f"{row}_resume"] = dict(max_rel_gap=gap, accuracy=correct)
            print(f"chip_smoke: main path: {row} 2 epochs: test accuracy "
                  f"{correct}/1000; 1 + resumed 1 epoch vs 2 straight: max "
                  f"rel gap {gap:.3e} "
                  f"({'bit-exact' if gap == 0 else 'NOT bit-exact'})")
        check(rec["mlp2_resume"]["accuracy"] > 500,
              f"mlp2 did not learn: {rec['mlp2_resume']['accuracy']}/1000")
        check(rec["mlp2_resume"]["max_rel_gap"] == 0.0,
              "mlp2's resumed run is not bit-exact on the card")
        check(rec["lenet_resume"]["max_rel_gap"] == 0.0,
              "lenet's resumed run is not bit-exact on the card")

        # the GPT through the CLI: K2 and K3 run per train step and layer,
        # K1 also per eval batch (the 1000-sequence test set at batch 60)
        _reset_flash_counts()
        glines = _cli(["--model", "gpt", "--attn", "flash", "--dryrun",
                       str(MAIN_GPT_STEPS), "--generate", "8"])
        counts = _flash_counts()
        n_layers = 2
        evals = -(-1000 // 60)
        want3 = (n_layers * (MAIN_GPT_STEPS + evals),
                 n_layers * MAIN_GPT_STEPS, n_layers * MAIN_GPT_STEPS)
        rec["gpt_cli"] = dict(console=glines, launches=counts,
                              expected=want3)
        print(f"chip_smoke: main path: gpt --attn flash --dryrun "
              f"{MAIN_GPT_STEPS} through the CLI: K1/K2/K3 launches "
              f"{counts} = {n_layers} layers x ({MAIN_GPT_STEPS} steps "
              f"[+ {evals} eval batches for K1]): {counts == want3}; "
              f"{[ln for ln in glines if TEST_RE.match(ln)]}")
        check(counts == want3, f"gpt CLI: flash launches {counts} != "
                               f"{want3}")
        check(any(ln.startswith("| sample tokens") for ln in glines),
              "gpt CLI: --generate printed no sample")

    rows = {}
    for row in ("lenet", "mlp2", "mlp4"):
        rows[row] = r = _time_row(row)
        print(f"chip_smoke: main path: {row} ({r['n_params']} params, "
              f"batch 60, SGD): step {r['step_ms']:.4f} ms (host clock, "
              f"{MAIN_TIMED_STEPS} steps), {r['samples_per_s']:.1f} "
              f"samples/s; profiled: {r['profiled_step_ms']:.4f} ms/step, "
              f"device {r['device_ms_per_step']:.4f} ms/step, busy "
              f"{r['device_busy_share']:.4f}, "
              f"{r['device_ops_per_step']:.1f} device ops/step; host ops "
              f"{r['host_ops_ms_per_step']:.4f} ms/step, most: " + ", ".join(
                  f"{h['name']} {h['us_per_step']:.1f} us"
                  for h in r["host_top"][:4]))
    rec["rows"] = rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this smoke runs on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        __import__(PORT)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        GPTConfig,
        make_gpt_stages,
    )
    record: dict = {}
    t_start = time.perf_counter()
    try:
        phase_build(record)
        variants = phase_kernels(record)
        flash_variants = phase_flash_kernels(record)
        cfg = GPTConfig(**SERVE_CFG)
        stages = make_gpt_stages(0, cfg, 1)[0]
        serve = phase_serve(stages, cfg, record)
        phase_profile(stages, cfg, record)
        del stages
        train = phase_train("gpt_bf16", TRAIN_ROWS["gpt_bf16"], record)
        phase_train("gpt", TRAIN_ROWS["gpt"], record)
        phase_train_profile(TRAIN_ROWS["gpt_bf16"], record)
        phase_main_path(record)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_v = next(v for v in variants
                  if v["dtype"] == "float32" and v["K"] == 1)
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": f"{PORT}/ops/csrc/paged_attention.cu",
        "replaces": "simple_distributed_machine_learning_tpu/ops/"
                    "paged_attention.py:67",
        "launches": serve["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"],
        "library_ms": None,
    }]}
    # the flash kernels' times at the gpt_bf16 row's shape; launches from
    # that row's flash training run
    for i, (name, line) in enumerate((("flash_forward", 127),
                                      ("flash_dq", 300),
                                      ("flash_dkv", 338))):
        timed = next(v for v in flash_variants if v["name"] == name
                     and v["dtype"] == "bfloat16"
                     and tuple(v["shape"]) == FLASH_SHAPE)
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/ops/csrc/flash_attention.cu",
            "replaces": "simple_distributed_machine_learning_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": train["launches"][i],
            "max_abs_err": max(v["max_abs_err"] for v in flash_variants
                               if v["name"] == name),
            "ms": timed["ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    record["kernels"] = kernels["kernels"]
    record["seconds"] = round(time.perf_counter() - t_start, 3)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"chip_smoke: card {card_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
