#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero
before the result line:

  1. device  -- needs ``torch.cuda.is_available()``; prints the card's name
                and power limit as ``nvidia-smi`` reports them.
  2. build   -- compiles the hand-written kernels from ``csrc/`` (nvcc,
                sm_90a) and prints the seconds and ptxas's register report.
  3. kernels -- ``folb_scores`` and ``folb_apply`` against their plain
                PyTorch versions on the card, bf16 and fp32 buffers, at the
                main-path shapes (K = 10, D_pad = 1,024 for MCLR and 114,688
                for the paper LSTM) and edge shapes (K = 1, K = 64, an odd
                tile count); a bit-identical repeat of ``folb_scores``; CUDA
                event times beside the bound, the plain version and one
                PyTorch library call.
  4. main path -- ``repro_torch.fed.run`` on the card: MCLR on
                Synthetic(1,1) with the quickstart config (20 rounds) and
                the paper LSTM at full width on char_stream (3 rounds).  The
                launch counters are zeroed just before and read just after
                each run and must equal the rounds run; losses are finite
                and the MCLR train loss falls.
  5. reference -- the card's runs agree with the port's plain CPU path on
                small inputs (MCLR and a narrow LSTM, fp32 buffers).

The last lines are the kernels summary, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6       # kernel vs plain: fp32 sums in another order
REF_ATOL = 1e-5               # card vs CPU run, fp32 buffers, few rounds

PALLAS = "src/repro/kernels/folb_aggregate.py"
SOURCE = "src/repro_torch/kernels/csrc/folb_aggregate.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(torch, fn, per_batch=20, batches=50) -> float:
    """Median device milliseconds per call: each batch of back-to-back
    calls is queued behind a spin kernel, so the events time the device
    work and not the host's launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_batch
                             for s, e in times)


def host_us(torch, fn, calls=200) -> float:
    """Host microseconds per call of back-to-back calls (launch cost)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound_ms(n_bytes: int, n_flops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_kernels(torch, K_mod):
    """Phase 3: every (shape, dtype) case against the plain versions."""
    shapes = [(10, 1024, "mclr"), (10, 114_688, "lstm"),
              (1, 114_688, "edge"), (64, 114_688, "edge"),
              (10, 7 * 1024, "edge")]
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows, errs = [], {"folb_scores": 0.0, "folb_apply": 0.0}
    for K, D, role in shapes:
        base = torch.randn(D, generator=gen)
        grads32 = base + torch.randn((K, D), generator=gen)
        deltas32 = 0.1 * torch.randn((K, D), generator=gen)
        w = torch.randn(D, generator=gen).to(dev)
        for dname, dt in dtypes.items():
            g = grads32.to(dev, dt)
            d = deltas32.to(dev, dt)
            g1 = g.float().mean(0)
            s_k = K_mod.folb_scores(g, g1)
            s_p = K_mod.folb_scores_plain(g, g1)
            torch.testing.assert_close(s_k, s_p, rtol=RTOL, atol=ATOL)
            if not torch.equal(s_k, K_mod.folb_scores(g, g1)):
                raise AssertionError("folb_scores repeat differs in bits")
            wt = s_p / s_p.abs().sum()
            a_k = K_mod.folb_apply(w, d, wt)
            a_p = K_mod.folb_apply_plain(w, d, wt)
            torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
            torch.cuda.synchronize()
            e_s = float((s_k - s_p).abs().max())
            e_a = float((a_k - a_p).abs().max())
            errs["folb_scores"] = max(errs["folb_scores"], e_s)
            errs["folb_apply"] = max(errs["folb_apply"], e_a)

            eb = g.element_size()
            g1_lib = g1.to(dt)
            w_lib, wt_lib = w.to(dt), wt.to(dt)
            d_t = d.t()
            sb, sb_by = bound_ms(K * D * eb + D * 4 + K * 4, 2 * K * D)
            ab, ab_by = bound_ms(D * 4 + K * D * eb + K * 4 + D * 4,
                                 2 * K * D + D)
            row = {
                "phase": "kernel", "K": K, "D_pad": D, "dtype": dname,
                "role": role,
                "folb_scores": {
                    "max_abs_err": e_s, "bit_identical_repeat": True,
                    "ms": device_ms(torch, lambda: K_mod.folb_scores(g, g1)),
                    "plain_ms": device_ms(
                        torch, lambda: K_mod.folb_scores_plain(g, g1)),
                    "library_ms": device_ms(
                        torch, lambda: torch.mv(g, g1_lib)),
                    "library": f"torch.mv ({dname})",
                    "call_us": host_us(torch,
                                       lambda: K_mod.folb_scores(g, g1)),
                    "bound_ms": sb, "bound_by": sb_by},
                "folb_apply": {
                    "max_abs_err": e_a,
                    "ms": device_ms(torch,
                                    lambda: K_mod.folb_apply(w, d, wt)),
                    "plain_ms": device_ms(
                        torch, lambda: K_mod.folb_apply_plain(w, d, wt)),
                    "library_ms": device_ms(
                        torch, lambda: torch.addmv(w_lib, d_t, wt_lib)),
                    "library": f"torch.addmv ({dname})",
                    "call_us": host_us(torch,
                                       lambda: K_mod.folb_apply(w, d, wt)),
                    "bound_ms": ab, "bound_by": ab_by},
            }
            emit(row)
            rows.append(row)
    return rows, errs


def main_path(torch, K_mod):
    """Phase 4: the port's front door on the card, counters zeroed just
    before each run and read just after."""
    from repro_torch import fed
    from repro_torch.configs.paper_models import LSTM, MCLR
    from repro_torch.data.federated import stack_devices
    from repro_torch.data.synthetic import char_stream, synthetic_alpha_beta

    runs = {
        "mclr": (MCLR, stack_devices(synthetic_alpha_beta(
            seed=0, n_devices=30, alpha=1.0, beta=1.0, mean_size=120),
            seed=0),
            fed.FLConfig(algo="folb", n_selected=10, mu=1.0, lr=0.05,
                         seed=0), 20),
        "lstm": (LSTM, stack_devices(char_stream(seed=0, n_devices=20),
                                     seed=0),
                 fed.FLConfig(algo="folb", n_selected=10, mu=1.0, lr=0.05,
                              seed=0), 3),
    }
    launches = {"folb_scores": 0, "folb_apply": 0}
    for name, (cfg, data, fl, rounds) in runs.items():
        K_mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fed.run(cfg, data, fl, rounds)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"folb_scores": K_mod.folb_scores.launches,
                  "folb_apply": K_mod.folb_apply.launches}
        losses = res["train_loss"]
        emit({"phase": "main_path", "model": name, "rounds": rounds,
              "n_devices": int(data.x.shape[0]),
              "max_examples": int(data.x.shape[1]),
              "seconds": secs, "seconds_per_round": secs / rounds,
              "launches": counts, "train_loss": losses,
              "test_acc": res["test_acc"]})
        for k, n in counts.items():
            if n != rounds:
                raise AssertionError(f"{name}: {k} launched {n} times in "
                                     f"{rounds} rounds")
            launches[k] += n
        if not all(map(lambda v: v == v and abs(v) != float("inf"),
                       losses)):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if name == "mclr" and not losses[-1] < losses[0]:
            raise AssertionError(f"MCLR train loss did not fall: {losses}")
    return launches


def against_cpu(torch):
    """Phase 5: the card's run agrees with the port's plain CPU path."""
    from repro_torch import fed
    from repro_torch.configs.paper_models import LSTM, MCLR
    from repro_torch.data.federated import stack_devices
    from repro_torch.data.synthetic import char_stream, synthetic_alpha_beta

    narrow = dataclasses.replace(LSTM, vocab=12, n_classes=12, seq_len=8,
                                 hidden=16, embed=8)
    cases = {
        "mclr": (MCLR, stack_devices(synthetic_alpha_beta(
            0, 12, 1.0, 1.0, mean_size=40), seed=0), 3),
        "lstm_narrow": (narrow, stack_devices(char_stream(
            0, 8, vocab=12, seq_len=8, mean_size=20, n_classes=12),
            seed=0), 2),
    }
    for name, (cfg, data, rounds) in cases.items():
        fl = fed.FLConfig(n_selected=4, max_local_steps=5,
                          agg_dtype="float32", seed=1)
        card = fed.run(cfg, data, fl, rounds)
        cpu = fed.run(cfg, data, fl, rounds, device="cpu")
        loss_err = max(abs(a - b) for a, b in
                       zip(card["train_loss"], cpu["train_loss"]))
        param_err = max(float((card.params[k].cpu() - cpu.params[k])
                              .abs().max()) for k in cpu.params)
        emit({"phase": "reference", "model": name, "rounds": rounds,
              "train_loss_max_abs_err": loss_err,
              "params_max_abs_err": param_err, "atol": REF_ATOL})
        if not (loss_err <= REF_ATOL and param_err <= REF_ATOL):
            raise AssertionError(f"{name}: card and CPU runs disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # fp32 products in full fp32 (the defaults, stated and set)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from repro_torch.kernels import build
    from repro_torch.kernels import folb_aggregate as K_mod
    t0 = time.perf_counter()
    build.load("folb_aggregate")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in build.build_logs["folb_aggregate"]
                    .splitlines() if "registers" in ln or "spill" in ln]})

    rows, errs = check_kernels(torch, K_mod)
    launches = main_path(torch, K_mod)
    against_cpu(torch)

    main_row = next(r for r in rows if r["role"] == "lstm"
                    and r["dtype"] == "bfloat16")
    replaces = {"folb_scores": f"{PALLAS}:119", "folb_apply": f"{PALLAS}:147"}
    summary = []
    for name in ("folb_scores", "folb_apply"):
        m = main_row[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": {"K": main_row["K"], "D_pad": main_row["D_pad"],
                      "dtype": main_row["dtype"]}})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
