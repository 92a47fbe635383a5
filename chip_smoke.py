#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build  — compile every CUDA kernel of the main path from ``csrc/``.
2. kernels vs plain — each kernel against its plain PyTorch version on the
   card, over shapes, bit widths, kneading strides and sparsities, to
   ``|kernel - plain| <= 1e-4 + 1e-5 * |plain|`` (tests/parity.py's bar:
   plane entries are in {-1, 0, 1}, so every product is exact and only the
   order of the f32 sums differs).
3. the slice — VGG-16 @ 32 at full width, random weights from a seed,
   served through ``CNNServingEngine(impl="kernel")`` ``submit()``/
   ``drain()``; logits held against ``impl="planes"`` (same bar) and
   ``impl="float"`` (quantization error), and the kernel's launch count
   held to 16 per forward (13 conv + 3 fc).
4. times — per VGG-16 layer at batch 8: the kernel, its plain version and
   one ``torch.matmul`` against the dequantized weight (a yardstick the
   port never calls), beside the least time the card could take.

Prints the card's name and power limit, one JSON line describing each
kernel, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result, without CUDA or without the repository beside it.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
RTOL, ATOL = 1e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNELS = {"sac_matmul": {
    "route": "cuda",
    "source": "src/repro_torch/csrc/sac_matmul.cu",
    "replaces": "src/repro/kernels/sac_matmul/kernel.py:99",
}}


def log(msg):
    print(msg, flush=True)


def check_close(got, want, what):
    """Max |got - want|; raises unless every element is within the bar."""
    import torch
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, "
                             f"max |err| {float(err.max()):.3g}")
    return float(err.max())


def cuda_time_ms(fn, reps, warmup=3):
    """Mean ms per call over ``reps`` back-to-back calls, after ``warmup``
    calls (the card idles while the plain version's host loop runs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for name in KERNELS:
        path, compiler_log, secs = build.build(name)
        log(f"[build] {name}: {path.name} ({secs:.1f} s)")
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(KERNELS)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")


def _sparse_weight(rng, k, n, sparsity):
    import numpy as np
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    if sparsity:
        w *= rng.random((k, n)) >= sparsity
    return w


def _kernel_and_plain(a, kw, mask=None, what=""):
    """Run the kernel at every M tile that fits and its plain version on the
    same padded inputs; check each against the plain output.  Returns (max
    |err|, kernel output at the default tile, plain output)."""
    from repro_torch.core.activation_occupancy import weight_only_mask
    from repro_torch.kernels.sac_matmul import kernel, ops
    a_p, m, _ = ops._pad_activations(a, kw)
    if mask is None:
        mask = weight_only_mask(kw.schedule.counts, kw.schedule.num_work)
    args = (a_p, kw.planes, kw.signs, kw.scale, kw.schedule)
    kwargs = dict(bits=kw.bits, bn=kw.n_block, bk=kw.ks, mask=mask)
    want = kernel.sac_matmul_plain(*args, **kwargs)[:m]
    got = kernel.sac_matmul_launch(*args, **kwargs)[:m]
    worst = check_close(got, want, what)
    for bm in kernel.cta_tiles(kw.bits, kw.ks):
        worst = max(worst, check_close(
            kernel.sac_matmul_launch(*args, **kwargs, cta_m=bm)[:m], want,
            f"{what} tile={bm}"))
    return worst, got, want


def phase_kernels(dev):
    import numpy as np
    import torch
    from repro_torch.core import activation_occupancy as ao
    from repro_torch.core.kneading import knead_padded
    from repro_torch.kernels.sac_matmul import ops
    rng = np.random.default_rng(SEED)
    shapes = [(24, 512, 128), (8, 1024, 256), (40, 768, 128),   # parity
              (8, 300, 100), (8, 27, 64), (8, 4800, 192),       # padded
              (1, 512, 128), (7, 1024, 256)]                    # GEMV
    worst, cases = 0.0, 0
    for m, k, n in shapes:
        for bits in (4, 8):
            for ks in (256, 512):
                for sparsity in (0.0, 0.7, 0.95):
                    w = _sparse_weight(rng, k, n, sparsity)
                    kw = knead_padded(torch.from_numpy(w).to(dev), bits=bits,
                                      ks=ks)
                    a = torch.from_numpy(rng.standard_normal(
                        (m, k)).astype(np.float32)).to(dev)
                    err, _, _ = _kernel_and_plain(
                        a, kw, what=f"M={m} K={k} N={n} bits={bits} ks={ks} "
                                    f"sparsity={sparsity}")
                    worst = max(worst, err)
                    cases += 1
    # wider codes: no 32-row tile fits at 16 bits and ks 512
    for bits, ks in ((12, 256), (16, 512)):
        w = _sparse_weight(rng, 1024, 256, 0.0)
        kw = knead_padded(torch.from_numpy(w).to(dev), bits=bits, ks=ks)
        a = torch.from_numpy(rng.standard_normal(
            (40, 1024)).astype(np.float32)).to(dev)
        worst = max(worst, _kernel_and_plain(a, kw,
                                             what=f"bits={bits} ks={ks}")[0])
        cases += 1
    # block-sparse weight: N tiles 1 and 2 are all zero (count 0), so their
    # epilogue must still write 0 * scale
    w = _sparse_weight(rng, 1024, 512, 0.5)
    w[:, 128:384] = 0.0
    kw = knead_padded(torch.from_numpy(w).to(dev), bits=8, ks=256)
    counts = kw.schedule.counts.cpu().tolist()
    assert counts[1] == counts[2] == 0 and counts[0] > 0, counts
    a = torch.from_numpy(rng.standard_normal(
        (24, 1024)).astype(np.float32)).to(dev)
    err, got, _ = _kernel_and_plain(a, kw, what="block-sparse")
    worst = max(worst, err)
    assert bool((got[:, 128:384] == 0).all()), "empty N tiles not zero"
    cases += 1
    # activation-intersected mask (the two-sided skip): K tiles 1 and 3 of
    # the activations are all zero
    w = _sparse_weight(rng, 1024, 256, 0.0)
    kw = knead_padded(torch.from_numpy(w).to(dev), bits=8, ks=256)
    a = torch.from_numpy(rng.standard_normal(
        (4, 1024)).astype(np.float32)).to(dev)
    a[:, 256:512] = 0.0
    a[:, 768:1024] = 0.0
    a_p, _, _ = ops._pad_activations(a, kw)
    mask = ao.work_mask(kw.schedule.counts, kw.schedule.ktile_ids,
                        ao.ktile_presence(a_p, kw.ks))
    assert int(mask.sum()) < kw.schedule.total_work
    err, got, _ = _kernel_and_plain(a, kw, mask, what="activation mask")
    worst = max(worst, err)
    _, unmasked, _ = _kernel_and_plain(a, kw, what="weight-only")
    worst = max(worst, check_close(got, unmasked, "mask vs weight-only"))
    cases += 1
    torch.cuda.synchronize()
    log(f"[kernels] sac_matmul: {cases} cases within "
        f"{ATOL:g} + {RTOL:g}*|plain|, max |kernel - plain| {worst:.3g}")
    return worst


def phase_slice(dev):
    import numpy as np
    import torch
    from repro_torch.inference.cnn_engine import (CNNServingConfig,
                                                  CNNServingEngine)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import cnn
    cfg = cnn.CNN_ZOO["vgg16"]
    params = cnn.init(cfg, torch.Generator().manual_seed(SEED), device=dev)
    images = np.random.default_rng(SEED).standard_normal(
        (11, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32)

    def serve(impl):
        t0 = time.perf_counter()
        eng = CNNServingEngine(cfg, params, CNNServingConfig(impl=impl),
                               device=dev)
        knead_s = time.perf_counter() - t0
        if impl == "kernel":
            LAUNCHES.clear()
        handles = [eng.submit(img) for img in images]
        results = eng.drain()
        launches = LAUNCHES["sac_matmul"]
        out = torch.stack([results[h] for h in handles])
        log(f"[slice] impl={impl}: knead {knead_s:.2f} s, "
            f"{eng.ticks} forwards, latency_stats {eng.latency_stats()}")
        return eng, out, launches

    eng, logits, launches = serve("kernel")
    if tuple(logits.shape) != (11, cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    want = 16 * eng.ticks
    if launches != want:
        raise AssertionError(f"sac_matmul launched {launches} times in "
                             f"{eng.ticks} forwards, expected {want}")
    log(f"[slice] sac_matmul launches {launches} = 16 x {eng.ticks} "
        "forwards")
    _, planes, _ = serve("planes")
    err = check_close(logits, planes, "VGG-16 kernel vs planes logits")
    if not torch.equal(logits.argmax(-1), planes.argmax(-1)):
        raise AssertionError("argmax differs between kernel and planes")
    _, flt, _ = serve("float")
    rel = float((logits - flt).abs().max() / flt.abs().max())
    if rel >= 0.1:
        raise AssertionError(f"kernel vs float logits off by {rel:.3g} "
                             "of max |logit|")
    agree = float((logits.argmax(-1) == flt.argmax(-1)).float().mean())
    log(f"[slice] vs planes max |err| {err:.3g}; vs float max rel "
        f"{rel:.3g}, argmax agreement {agree:.3f}")
    return eng, launches, err


def layer_bound(m, kw, num_work, logical=False):
    """Least time (s) for one launch: the larger of the FP32 flops over the
    card's FP32 rate and the bytes over its memory rate.  Counts this
    weight's scheduled plane tiles, not the dense planes.  The tiles cover
    K and N padded to ks and 128; with ``logical`` the tile work, plane
    bytes, activations and output shrink to the unpadded K x N."""
    k, n = (kw.logical_k, kw.logical_n) if logical else (kw.k, kw.n)
    fill = k * n / (kw.k * kw.n)
    flops = 2 * m * kw.ks * kw.n_block * kw.schedule.total_work * fill
    words_per_tile = kw.ks // 32 * kw.n_block
    nbytes = 4 * (m * k                                  # activations
                  + kw.schedule.total_work * words_per_tile * fill  # planes
                  + (kw.signs.numel() + kw.scale.numel()) * fill
                  + 3 * kw.schedule.n_tiles * num_work   # mask + ids
                  + m * n)                               # output
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_times(eng, dev):
    import numpy as np
    import torch
    from repro_torch.core.activation_occupancy import weight_only_mask
    from repro_torch.core.kneading import unknead
    from repro_torch.kernels.sac_matmul import kernel, ops
    from repro_torch.models import cnn
    x = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        _, acts = cnn.apply(eng.params, x, eng.cfg, impl="kernel",
                            collect_activations=True)
        rows = []
        for name, a in acts.items():
            kw = eng.params[name]["w"]
            a_p, _, _ = ops._pad_activations(a, kw)
            mask = weight_only_mask(kw.schedule.counts, kw.schedule.num_work)
            args = (a_p, kw.planes, kw.signs, kw.scale, kw.schedule)
            kwargs = dict(bits=kw.bits, bn=kw.n_block, bk=kw.ks, mask=mask)
            w_dense = unknead(kw)
            err = check_close(kernel.sac_matmul_launch(*args, **kwargs),
                              kernel.sac_matmul_plain(*args, **kwargs),
                              f"{name} kernel vs plain")
            k_ms = cuda_time_ms(lambda: kernel.sac_matmul_launch(
                *args, **kwargs), 20)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            tile = kernel.cta_rows(a_p.shape[0], kw.n, kw.bits, kw.ks, sms)
            by_tile = {bm: 1e3 * cuda_time_ms(lambda: kernel.sac_matmul_launch(
                *args, **kwargs, cta_m=bm), 20) for bm in (8, 16, 32)}
            p_ms = cuda_time_ms(lambda: kernel.sac_matmul_plain(
                *args, **kwargs), 3, warmup=1)
            l_ms = cuda_time_ms(lambda: torch.matmul(a_p, w_dense), 20)
            bound_s, bound_by = layer_bound(a_p.shape[0], kw,
                                            kw.schedule.num_work)
            logical_s, _ = layer_bound(a_p.shape[0], kw,
                                       kw.schedule.num_work, logical=True)
            rows.append(dict(layer=name, M=a_p.shape[0], K=kw.k, N=kw.n,
                             K_logical=kw.logical_k, N_logical=kw.logical_n,
                             total_work=kw.schedule.total_work,
                             tile=tile, kernel_us=k_ms * 1e3,
                             kernel_us_by_tile=by_tile, plain_us=p_ms * 1e3,
                             matmul_us=l_ms * 1e3,
                             bound_us=bound_s * 1e6, bound_by=bound_by,
                             bound_logical_us=logical_s * 1e6,
                             max_abs_err=err))
    log("[times] layer   M     K(logical)  N(logical)  total_work  tile "
        "kernel_us  plain_us  matmul_us  bound_us(logical)  bound_by  "
        "kernel_us@8/16/32")
    for r in rows:
        t = r["kernel_us_by_tile"]
        log(f"[times] {r['layer']:<6} {r['M']:>5} {r['K']:>5}({r['K_logical']:>4})"
            f" {r['N']:>5}({r['N_logical']:>4}) {r['total_work']:>10} "
            f"{r['tile']:>5} {r['kernel_us']:>9.1f} {r['plain_us']:>9.1f} "
            f"{r['matmul_us']:>10.1f} {r['bound_us']:>9.2f}"
            f"({r['bound_logical_us']:.2f})  "
            f"{r['bound_by']:<10}  {t[8]:.1f}/{t[16]:.1f}/{t[32]:.1f}")
    log("[times] rows " + json.dumps(rows))
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build()
    worst = phase_kernels(dev)
    eng, launches, slice_err = phase_slice(dev)
    rows = phase_times(eng, dev)
    bound_ops = sum(r["bound_us"] for r in rows if r["bound_by"] == "operations")
    bound_bytes = sum(r["bound_us"] for r in rows if r["bound_by"] == "bytes")
    kernels = [dict(
        name="sac_matmul", **KERNELS["sac_matmul"], launches=launches,
        max_abs_err=max(worst, slice_err, max(r["max_abs_err"] for r in rows)),
        ms=sum(r["kernel_us"] for r in rows) / 1e3,
        plain_ms=sum(r["plain_us"] for r in rows) / 1e3,
        bound_ms=(bound_ops + bound_bytes) / 1e3,
        bound_by="operations" if bound_ops >= bound_bytes else "bytes",
        library_ms=sum(r["matmul_us"] for r in rows) / 1e3)]
    log(f"[done] {time.perf_counter() - t0:.1f} s; times are one VGG-16 "
        "forward at batch 8, summed over its 16 layers; bound_ms counts the "
        "padded kneaded tiles, at the unpadded K x N it is "
        f"{sum(r['bound_logical_us'] for r in rows) / 1e3:.4f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
