#!/usr/bin/env python3
"""Card-side smoke of the PyTorch port (spark_rapids_ml_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which exits non-zero on a failed check:

1. The card (``nvidia-smi`` name and power limit), torch/CUDA/nvcc
   versions, and the build of every ``ops/csrc/*.cu`` with nvcc for sm_90a.
2. Each kernel against its plain PyTorch version on the card, at ragged
   shapes (tolerances stated beside each check).
3. The streaming fit at full width (d=2048, k=32, bf16 batches of 262,144
   rows) through ``fit_pca_stream``; the ``gram_colsum`` launches must
   equal the batch count; components checked sign-invariantly against a
   float64 Gram of the same batches computed on the card.
4. The in-memory ``PCA().fit`` of 1,048,576 x 2048 float32 rows (four
   batches' worth, so one launch sums far more rows than a batch) through
   the ``gram`` kernel, with the same check.
5. Transform of 65,536 rows against a float64 product; its p50 latency.
6. Each kernel timed at the main path's shape beside its plain version,
   its bound and the ``torch.matmul`` yardstick, and the Gram error of the
   kernel and of the plain version against a float64 Gram.

The last lines are the card line, the ``{"kernels": [...]}`` table and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

D, K = 2048, 32  # bench.py:113-114
BATCH_ROWS = 1 << 18  # bench.py:115
N_BATCHES = 8  # cut from the 384 batches (100.7M rows) of bench.py:119
LAST_BATCH_ROWS = BATCH_ROWS - 12345  # the stream's ragged tail
IN_MEMORY_ROWS = 4 * BATCH_ROWS
TRANSFORM_ROWS = 65536
DEV = "cuda"

# H100 SXM data sheet peaks (dense): bf16 tensor cores, f32 FFMA, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "spark_rapids_ml_tpu_torch/ops/csrc/gram.cu"
REPLACES = {
    "gram_colsum": "spark_rapids_ml_tpu/ops/pallas_kernels.py:173",
    "gram": "spark_rapids_ml_tpu/ops/pallas_kernels.py:78",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(("ok    " if ok else "FAIL  ") + msg, flush=True)
    if not ok:
        fail(msg)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def rel_err(out, ref, scale) -> float:
    """max |out − ref| over a scale bounding the entries' absolute sums."""
    return float((out.double() - ref.double()).abs().max()) / max(float(scale), 1e-30)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sign_aligned_err(pc, ref) -> float:
    """max over columns of min(|a − b|∞, |a + b|∞): sign-invariant."""
    import torch

    pc = torch.as_tensor(pc, dtype=torch.float64, device=ref.device)
    plus = (pc - ref).abs().max(dim=0).values
    minus = (pc + ref).abs().max(dim=0).values
    return float(torch.minimum(plus, minus).max())


def reference_pca(count, colsum, gram, k):
    """Float64 eigh of the centred Gram: (top-k vectors, σ/Σσ, smallest
    gap between the top k+1 eigenvalues over the largest)."""
    import torch

    g = gram - torch.outer(colsum / count, colsum)
    w, v = torch.linalg.eigh(g)
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0))
    gap = float((w[:k] - w[1:k + 1]).min() / w[0])
    return v[:, :k], s[:k] / s.sum(), gap


def make_rows(gen, rows, scales, mu, dtype):
    """Rows with a decaying, well-separated spectrum: z·s + μ."""
    import torch

    z = torch.randn((rows, D), generator=gen, device=DEV, dtype=torch.float32)
    return (z * scales + mu).to(dtype)


def phase_kernels(torch, kernels) -> None:
    gen = torch.Generator(device=DEV).manual_seed(1)
    # Ragged against the 16-row chunk, the 8192-row split (three splits)
    # and the 128 tile.
    n, d = 20001, 300
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=gen, device=DEV).to(dtype)
        gscale = float((x.float() ** 2).sum(0).max())
        cscale = float(x.float().abs().sum(0).max())
        for n_valid in (n, 17000, 1234, 0):
            for seeded in (False, True):
                g0 = torch.randn((d, d), generator=gen, device=DEV)
                cs0 = torch.randn((d,), generator=gen, device=DEV)
                c0 = torch.tensor(37.0, device=DEV)
                st_k = (g0.clone(), cs0.clone(), c0.clone()) if seeded else None
                st_p = (g0.clone(), cs0.clone(), c0.clone()) if seeded else None
                gk, csk, ck = kernels.gram_colsum(x, n_valid, st_k)
                gp, csp, cp = kernels.gram_colsum_plain(x, n_valid, st_p)
                torch.cuda.synchronize()
                tag = f"gram_colsum {str(dtype)[6:]} n={n} d={d} n_valid={n_valid} seeded={seeded}"
                # Tolerance: f32 sums in another order over <= 20001 rows,
                # 1e-5 of the largest absolute row sum of each output.
                check(rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5, tag + " gram")
                check(rel_err(csk, csp, max(cscale, 1.0)) <= 1e-5, tag + " colsum")
                check(float(ck) == float(cp), tag + f" count {float(ck)}")
        mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float()
        gk = kernels.gram(x, mask)
        gp = kernels.gram_plain(x, mask)
        torch.cuda.synchronize()
        check(
            rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5,
            f"gram {str(dtype)[6:]} n={n} d={d} random {{0,1}} mask (tol 1e-5 of max Σx²)",
        )
        gk = kernels.gram(x)
        gp = kernels.gram_plain(x)
        torch.cuda.synchronize()
        check(rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5,
              f"gram {str(dtype)[6:]} n={n} d={d} no mask (tol 1e-5 of max Σx²)")


def bound_ms(n_bytes: float, ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_ml_tpu_torch import PCA, PCAModel, config
    from spark_rapids_ml_tpu_torch.models.pca import fit_pca_stream
    from spark_rapids_ml_tpu_torch.ops import _build, kernels

    t_start = time.perf_counter()
    # -- 1. card, toolchain, build ---------------------------------------
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print("nvcc:", run([_build.nvcc(), "--version"]).splitlines()[-1])
    t0 = time.perf_counter()
    built = _build.build_all()
    kernels._lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(p.name for p in built))
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernels against their plain versions -----------------------------
    phase_kernels(torch, kernels)

    # -- 3. streaming fit at full width ---------------------------------------
    gen = torch.Generator(device=DEV).manual_seed(0)
    j = torch.arange(D, device=DEV, dtype=torch.float32)
    # Column variances 2 − j/31 for the top 32 (eigengaps 1.6 % of the
    # largest), then a 0.01·0.998^j tail far below them.
    scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
    mu = 0.05 * torch.randn((D,), generator=gen, device=DEV)
    batches = [
        make_rows(gen, LAST_BATCH_ROWS if b == N_BATCHES - 1 else BATCH_ROWS,
                  scales, mu, torch.bfloat16)
        for b in range(N_BATCHES)
    ]
    n_rows = sum(b.shape[0] for b in batches)
    print(f"streaming fit: {N_BATCHES} bf16 batches, {n_rows} rows x {D} "
          f"(depth cut from bench.py's 384 batches), k={K}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = fit_pca_stream(batches, k=K, n_cols=D)
    fit_s = time.perf_counter() - t0  # the solution is on the host: synced
    launches_gc = kernels.LAUNCHES["gram_colsum"]
    check(launches_gc == N_BATCHES,
          f"gram_colsum launches {launches_gc} == batches {N_BATCHES}")
    print(f"streaming fit: {fit_s:.3f} s, {n_rows / fit_s:.1f} rows/s (fold + finalize)")
    count = torch.tensor(float(n_rows), dtype=torch.float64, device=DEV)
    colsum = torch.zeros(D, dtype=torch.float64, device=DEV)
    gram = torch.zeros((D, D), dtype=torch.float64, device=DEV)
    for b in batches:
        xd = b.double()
        gram += xd.T @ xd
        colsum += xd.sum(0)
    pc_ref, ev_ref, gap = reference_pca(count, colsum, gram, K)
    print(f"streaming reference: smallest top-{K} eigengap {gap:.3e} of the largest eigenvalue")
    err = sign_aligned_err(sol.pc, pc_ref)
    ev_err = float((torch.as_tensor(sol.explained_variance, device=DEV) - ev_ref).abs().max())
    check(sol.pc.shape == (D, K) and bool(torch.isfinite(torch.as_tensor(sol.pc)).all()),
          f"streaming pc finite, shape {sol.pc.shape}")
    # Tolerance: f32 accumulation over 2M rows (relative error ~1e-5 of the
    # largest Gram entry at worst) over the smallest top-32 eigengap (1.6 %
    # of the largest eigenvalue) bounds the vector error near 1e-3.
    check(err <= 1e-3, f"streaming pc vs float64 Gram: max sign-aligned err {err:.3e} (tol 1e-3)")
    check(ev_err <= 1e-4, f"streaming explained variance err {ev_err:.3e} (tol 1e-4)")
    del gram, colsum

    # -- 4. in-memory PCA().fit in float32 through the gram kernel ------------
    x32 = make_rows(gen, IN_MEMORY_ROWS, scales, mu, torch.float32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with config.option("compute_dtype", "float32"):
        model32 = PCA().setK(K).fit({"features": x32})
    mem_s = time.perf_counter() - t0
    launches_g = kernels.LAUNCHES["gram"]
    check(launches_g == 1, f"gram launches {launches_g} == 1 in the in-memory fit")
    print(f"in-memory fit: {IN_MEMORY_ROWS} x {D} float32 in {mem_s:.3f} s")
    xd = x32.double()
    g64_mem = xd.T @ xd  # kept for phase 6's Gram error
    pc_ref, ev_ref, gap = reference_pca(
        torch.tensor(float(IN_MEMORY_ROWS), dtype=torch.float64, device=DEV),
        xd.sum(0), g64_mem, K,
    )
    del xd
    print(f"in-memory reference: smallest top-{K} eigengap {gap:.3e} of the largest eigenvalue")
    err = sign_aligned_err(model32.pc, pc_ref)
    check(err <= 1e-3, f"in-memory pc vs float64 Gram: max sign-aligned err {err:.3e} (tol 1e-3)")

    # -- 5. transform ----------------------------------------------------------
    # The streaming fit's model; transform computes in bf16 (auto on CUDA).
    model = PCAModel(pc=sol.pc, explained_variance=sol.explained_variance, mean=sol.mean)
    xq = batches[0][:TRANSFORM_ROWS]
    y = model.transform_matrix(xq)["output"]
    cd = config.compute_dtype(DEV)  # both operands rounded to it
    pc_c = torch.as_tensor(sol.pc, device=DEV).to(cd).double()
    y_ref = xq.to(cd).double() @ pc_c
    scale = float((xq.double().abs() @ pc_c.abs()).max())
    terr = rel_err(y, y_ref, scale)
    check(tuple(y.shape) == (TRANSFORM_ROWS, K) and y.dtype == torch.float32,
          f"transform output {tuple(y.shape)} {y.dtype}")
    # Tolerance: the same rounded operands summed in f32 over 2048 terms.
    check(terr <= 1e-5, f"transform vs float64 product: rel err {terr:.3e} (tol 1e-5)")
    lat = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform_matrix(xq)["output"].sum().item()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    print(f"transform {TRANSFORM_ROWS} x {D} bf16 -> k={K}: p50 {lat[len(lat) // 2]:.3f} ms "
          f"(device-resident input, host clock, synced)")

    # -- 6. kernels at the main path's shape ------------------------------------
    table = []
    xb = batches[0]
    del batches
    xbd = xb.double()
    g64_batch = xbd.T @ xbd
    del xbd
    n, d = xb.shape
    state = (torch.zeros((d, d), device=DEV), torch.zeros(d, device=DEV),
             torch.zeros((), device=DEV))
    ms = time_ms(lambda: kernels.gram_colsum(xb, n, state), 5)
    plain_ms = time_ms(lambda: kernels.gram_colsum_plain(xb, n, state), 3)
    lib_ms = time_ms(lambda: torch.matmul(xb.T, xb), 5)
    gk = kernels.gram_colsum(xb, n)
    gp = kernels.gram_colsum_plain(xb, n)
    gscale = float(gp[0].diagonal().max())
    cscale = float(xb.float().abs().sum(0).max())
    err_g = rel_err(gk[0], gp[0], gscale)
    err_c = rel_err(gk[1], gp[1], cscale)
    # Tolerance: f32 sums over 262,144 rows in another order, 1e-4 relative.
    check(err_g <= 1e-4 and err_c <= 1e-4 and float(gk[2]) == float(gp[2]),
          f"gram_colsum at {n} x {d} bf16: rel err gram {err_g:.2e}, colsum {err_c:.2e} (tol 1e-4)")
    print(f"gram_colsum at {n} x {d} bf16, Gram vs float64 (over the largest diagonal "
          f"entry): kernel {rel_err(gk[0], g64_batch, gscale):.3e}, "
          f"plain {rel_err(gp[0], g64_batch, gscale):.3e}")
    # Bound: x read once, the state read and written once; G is symmetric,
    # so nd(d+1) operations, plus nd for the column sums.
    b_ms, b_by = bound_ms(n * d * 2 + 2 * (d * d * 4 + d * 4 + 4), n * d * (d + 1) + n * d,
                          "bfloat16")
    table.append({
        "name": "gram_colsum", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["gram_colsum"], "launches": launches_gc,
        "max_abs_err": float((gk[0] - gp[0]).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    del gk, gp, state, xb

    # The in-memory fit passes no mask (one device pads nothing).
    n, d = x32.shape
    ms = time_ms(lambda: kernels.gram(x32), 3)
    plain_ms = time_ms(lambda: kernels.gram_plain(x32), 3)
    lib_ms = time_ms(lambda: torch.matmul(x32.T, x32), 3)  # TF32 off: the package pins it
    gk = kernels.gram(x32)
    gp = kernels.gram_plain(x32)
    gscale = float(gp.diagonal().max())
    err_g = rel_err(gk, gp, gscale)
    check(err_g <= 1e-4, f"gram at {n} x {d} f32: rel err {err_g:.2e} (tol 1e-4)")
    print(f"gram at {n} x {d} f32, Gram vs float64 (over the largest diagonal entry): "
          f"kernel {rel_err(gk, g64_mem, gscale):.3e}, plain {rel_err(gp, g64_mem, gscale):.3e}")
    # Bound: x read once, G written once; G is symmetric, so nd(d+1).
    b_ms, b_by = bound_ms(n * d * 4 + d * d * 4, n * d * (d + 1), "float32")
    table.append({
        "name": "gram", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["gram"], "launches": launches_g,
        "max_abs_err": float((gk - gp).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    for row in table:
        print(f"{row['name']}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"torch.matmul {row['library_ms']:.3f}, bound {row['bound_ms']:.3f} by "
              f"{row['bound_by']}), {row['launches']} launches on the main path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
