#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port builds, is right and serves on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It imports only the port (``simple_distributed_machine_learning_tpu_torch``)
and torch — no JAX — and exits non-zero, printing no result, without CUDA
or without the port beside it. Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of every kernel of the serving path from the checkout's
   sources (``nvcc`` into the git-ignored ``_build/`` directory);
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes (H = 8, dh = 64, block 16, 8 slots, positions up to
   255), for every cache dtype and K = 1 and 4, within rtol = atol =
   1e-5 (both read the same stored bytes); a narrow pool's answer also
   within ``tests/tolerances.py::attn_tol`` of the unquantised f32
   pool's. Each is timed with CUDA events (one pair around a run of 40
   calls, the L2 flushed before each call, the flushes' own time
   subtracted; median of 5 runs) beside its plain version and its bound;
3. the port's main path at full width: ``InferenceEngine(attn_kernel=
   "fused")`` serving the ``gpt_serve`` trace (24 requests, Poisson
   32/s, prompts 8/16/32, 24 new tokens) on the 21 M-parameter GPT
   (vocab 8192, seq 256, d 512, 8 heads, 4 layers; random weights from
   seed 0). It must complete 24/24, launch the kernel n_layers times per
   decode tick, and give every greedy stream equal to an ``attn_kernel=
   "dense"`` engine's and to the solo ``make_cached_decoder``'s;
4. where a decode tick's time goes: a steady window at full occupancy (8
   slots), timed on the host clock, then traced with ``torch.profiler`` —
   the device's busy share and its time by kernel (``PERF.md`` section 5).

Before the last line it prints the kernels as one JSON object (times in
ms, measured in this run; ``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = "simple_distributed_machine_learning_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores (the kernel's dots run on the CUDA cores in f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# (rtol, atol) of the kernel against its plain version: both read the same
# stored bytes and scales, so only f32 summation order differs
SAME_BYTES_TOL = (1e-5, 1e-5)
# tests/tolerances.py::attn_tol's (rtol, atol) per storage dtype: a narrow
# pool's answer against the unquantised f32 pool's
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 5e-2),
            "int8": (6e-2, 6e-2), "float8_e4m3fn": (1.5e-1, 1.5e-1),
            "float8_e5m2": (1.5e-1, 1.5e-1)}
SERVE_CFG = dict(vocab=8192, seq_len=256, d_model=512, n_heads=8, n_layers=4)
SERVE_SLOTS, SERVE_BLOCK = 8, 16
SERVE_SIM = dict(n_requests=24, rate=32.0, seed=0, prompt_lens=(8, 16, 32),
                 max_new_tokens=24)


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
    t0 = time.perf_counter()
    built = build_kernel()
    record["build_s"] = round(time.perf_counter() - t0, 3)
    print(f"chip_smoke: built {built.path.name} in {record['build_s']} s "
          f"(nvcc {built.build_s:.3f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"chip_smoke:   ptxas {line.strip()}")


# -- phase 2 ------------------------------------------------------------------

def _pool_case(name: str, K: int, gen, dev):
    """The serving pool's shapes: [L=4, 129 blocks, 8 heads, 16, 64], one
    layer's view handed to the kernel as the engine does; 8 slots with
    ragged tables (trash 0 past each slot's position), one slot routed
    to the trash like a non-decoding slot."""
    import torch
    from simple_distributed_machine_learning_tpu_torch.models.gpt import (
        _quantize_rows,
    )
    L, nblk, H, bs, dh, S = 4, 129, 8, SERVE_BLOCK, 64, SERVE_SLOTS
    NB = 256 // bs
    kc = torch.randn((L, nblk, H, bs, dh), generator=gen)
    vc = torch.randn((L, nblk, H, bs, dh), generator=gen)
    if name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        (kd, ks), (vd, vs) = _quantize_rows(kc, name), _quantize_rows(vc, name)
    else:
        kd, vd = kc.to(getattr(torch, name)), vc.to(getattr(torch, name))
        ks = vs = None
    pos = torch.randint(0, 256, (S,), generator=gen)
    pos[0], pos[S - 1] = 255, 0
    qpos = torch.clamp(pos[:, None] + torch.arange(K)[None, :], max=255)
    perm = torch.randperm(nblk - 1, generator=gen) + 1
    tables = torch.zeros((S, NB), dtype=torch.int32)
    for s in range(S - 1):
        n = int(qpos[s, -1]) // bs + 1
        tables[s, :n] = perm[s * NB:s * NB + n]
    q = torch.randn((S, H, K, dh), generator=gen)
    li = 2
    to = (lambda t: None if t is None else t.to(dev))
    return dict(q=to(q), kc=to(kd)[li], vc=to(vd)[li], tables=to(tables),
                qpos=to(qpos.to(torch.int32).contiguous()),
                kscale=None if ks is None else to(ks)[li],
                vscale=None if vs is None else to(vs)[li], bs=bs,
                kc32=to(kc[li]), vc32=to(vc[li]))


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

            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (out - ref).abs()
            rtol, atol = SAME_BYTES_TOL
            ok = bool(torch.isfinite(out).all()) and bool(
                (err <= atol + rtol * ref.abs()).all())
            max_abs = float(err.max())
            max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
            # the narrow pool's answer against the unquantised pool's
            wide = paged_attention_reference(
                c["q"], c["kc32"], c["vc32"], c["tables"], c["qpos"],
                block_size=c["bs"])
            werr = (out - wide).abs()
            wrtol, watol = ATTN_TOL[name]
            wide_ok = bool((werr <= watol + wrtol * wide.abs()).all())
            bound_ms, bound_by = _bound(c)
            v = dict(dtype=name, K=K, max_abs_err=max_abs,
                     max_rel_err=max_rel, rtol=rtol, atol=atol,
                     max_abs_err_vs_f32=float(werr.max()),
                     rtol_vs_f32=wrtol, atol_vs_f32=watol,
                     ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                     bound_ms=bound_ms, bound_by=bound_by)
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
    print("chip_smoke: paged_attention library_ms: none — no single "
          "PyTorch call computes block-table-gathered attention "
          "(scaled_dot_product_attention needs the rows gathered first)")
    record["kernel_variants"] = variants
    return variants


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
        cfg = GPTConfig(**SERVE_CFG)
        stages = make_gpt_stages(0, cfg, 1)[0]
        serve = phase_serve(stages, cfg, record)
        phase_profile(stages, cfg, record)
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
