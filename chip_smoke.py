#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero
before the result line:

  1. device  -- needs ``torch.cuda.is_available()``; prints the card's name
                and power limit as ``nvidia-smi`` reports them.
  2. build   -- compiles the hand-written kernels from ``csrc/`` (one nvcc
                per source, sm_90a, all started together) and prints the
                seconds and ptxas's register report.
  3. kernels -- ``folb_scores``, ``folb_apply`` and ``guard_stats`` against
                their plain PyTorch versions on the card, bf16 and fp32
                buffers, at the main-path shapes (K = 10, D_pad = 1,024 for
                MCLR and 114,688 for the paper LSTM) and edge shapes (K = 1,
                K = 64, an odd tile count); ``guard_stats`` also on inputs
                with NaN, +Inf and -Inf planted in rows of the deltas only,
                the grads only, and both; bit-identical repeats of the two
                two-launch kernels; CUDA event times beside the bound, the
                plain version and, where one exists, one PyTorch library
                call.
  3b. attention and scan kernels -- ``flash_attention`` against its plain
                version at the Zamba2 prefill shape (bf16), fed100m's
                (fp32), GQA with a sliding window, a ragged S, non-causal
                and a 256-wide head; ``ssd_scan`` at Zamba2's full width, the
                reduced shape, S = chunk and the largest state (N = 128) at
                P = 64, 384 and 1024, y and the final state both checked;
                ``slstm_scan`` at xLSTM-1.3B's sLSTM shape (B 4, S 512, H 4,
                dh 512) in bf16 and fp32, at a prime S and at the reduced
                width, out and the final (h, c, n) both checked; times as in
                phase 3 (the library call for attention is
                ``scaled_dot_product_attention``; none computes either
                scan).  And the time of the plain ``ssd_chunked`` at the
                xLSTM mLSTM's shape (P = 1025, N = 1024), which
                ``ssd_scan`` must refuse.
  4. main path -- ``repro_torch.fed.run`` on the card: MCLR on
                Synthetic(1,1) with the quickstart config (20 rounds), the
                paper LSTM at full width on char_stream (3 rounds), and the
                same LSTM guarded under a failure scenario with drops, NaN
                and norm-inflated payloads (3 rounds).  The launch counters
                are zeroed just before and read just after each run and must
                equal the rounds run (``guard_stats``: the guarded rounds);
                losses are finite and the MCLR train loss falls.
  4b. guard  -- MCLR at the settings of ``benchmarks/resilience.py`` (30
                devices, 40 rounds, 5 % corruption): clean, corrupted
                unguarded and corrupted guarded; the guarded run must be
                finite and within 0.05 test accuracy of the clean run.  One
                corrupted round through ``fed.simulator.fl_round`` must
                count each NaN row that arrived as non-finite.
  4c. serve  -- ``repro_torch.launch.serve.main`` on xLSTM-1.3B and
                Zamba2-2.7B at full width and depth (bf16, batch 4, prompt
                512, 16 greedy tokens), then fed100m: prefill seconds,
                decode tokens/s, finite logits; the counters, zeroed just
                before, must read 6 ``slstm_scan`` launches for xLSTM (its
                mLSTM recurrence is the plain ``ssd_chunked``), 9
                ``flash_attention`` and 54 ``ssd_scan`` for Zamba2, and 12
                ``flash_attention`` for fed100m, after the prefill and the
                15 decode steps, so decode launches none.
  5. reference -- the card's runs agree with the port's plain CPU path on
                small inputs (MCLR and a narrow LSTM, fp32 buffers), clean
                and guarded under a failure scenario; and reduced xLSTM and
                Zamba2 (two super-groups each) and fed100m prefill + 3
                decode steps in fp32.

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
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
RTOL, ATOL = 1e-5, 1e-6       # kernel vs plain: fp32 sums in another order
REF_ATOL = 1e-5               # card vs CPU run, fp32 buffers, few rounds
RESILIENCE_TOL = 0.05         # guarded vs clean final test accuracy
GUARD_KW = {"nonfinite": True, "clip_mult": 5.0, "gate_mult": 20.0}
FOLB_KERNELS = ("folb_scores", "folb_apply", "guard_stats")
KERNELS = FOLB_KERNELS + ("flash_attention", "ssd_scan", "slstm_scan")
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # the reference's bounds
SSD_ATOL, SSD_RTOL = 2e-4, 1e-4   # step-by-step vs chunked fp32 rounding
# slstm_scan vs plain: the same fp32 recurrence, products summed in another
# order; out (|h| <= 1) in bf16 within two bf16 ulps at unit scale, where
# one rounding of h may land either side; states within 1e-4
SLSTM_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
SLSTM_STATE_TOL = 1e-4
MODEL_ATOL = 1e-4                 # card vs CPU logits, fp32, unit scale

PALLAS = "src/repro/kernels/folb_aggregate.py"
SOURCE = "src/repro_torch/kernels/csrc/folb_aggregate.cu"
REPLACES = {"folb_scores": f"{PALLAS}:119", "folb_apply": f"{PALLAS}:147",
            "guard_stats": f"{PALLAS}:180",
            "flash_attention": "src/repro/kernels/flash_attention.py:101",
            "ssd_scan": "src/repro/kernels/ssm_scan.py:73",
            "slstm_scan": "src/repro/kernels/slstm_scan.py:76"}
SOURCES = {"folb_scores": SOURCE, "folb_apply": SOURCE, "guard_stats": SOURCE,
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssm_scan.cu",
           "slstm_scan": "src/repro_torch/kernels/csrc/slstm_scan.cu"}


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


def bound_ms(n_bytes: int, n_flops: int,
             flop_per_s: float = FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def plant_nonfinite(torch, deltas, grads):
    """Copies of the buffers with NaN, +Inf and -Inf planted in chosen rows:
    the deltas only (row 1), the grads only (row 2) and both (row 3), at
    lanes in the first and the last tile; with fewer rows, both in row 0."""
    d, g = deltas.clone(), grads.clone()
    K, D = d.shape
    nan, inf = float("nan"), float("inf")
    rows = {1: "deltas", 2: "grads", 3: "both"} if K > 3 else {0: "both"}
    for r, where in rows.items():
        lo, hi = 37 * r % D, D - 1 - r
        if where in ("deltas", "both"):
            d[r, lo], d[r, hi] = nan, inf
        if where in ("grads", "both"):
            g[r, lo], g[r, hi] = -inf, nan
    return d, g


def check_kernels(torch, K_mod):
    """Phase 3: every (shape, dtype) case against the plain versions."""
    shapes = [(10, 1024, "mclr"), (10, 114_688, "lstm"),
              (1, 114_688, "edge"), (64, 114_688, "edge"),
              (10, 7 * 1024, "edge")]
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows, errs = [], {name: 0.0 for name in FOLB_KERNELS}
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
            e_g = 0.0
            for dd, gg in ((d, g), plant_nonfinite(torch, d, g)):
                n_k, f_k = K_mod.guard_stats(dd, gg)
                n_p, f_p = K_mod.guard_stats_plain(dd, gg)
                if not torch.equal(f_k, f_p):
                    raise AssertionError(f"guard_stats flags {f_k.tolist()}"
                                         f" != plain {f_p.tolist()}")
                torch.testing.assert_close(n_k, n_p, rtol=RTOL, atol=ATOL)
                n_r, f_r = K_mod.guard_stats(dd, gg)
                if not (torch.equal(n_k, n_r) and torch.equal(f_k, f_r)):
                    raise AssertionError("guard_stats repeat differs in bits")
                e_g = max(e_g, float((n_k - n_p).abs().max()))
            torch.cuda.synchronize()
            e_s = float((s_k - s_p).abs().max())
            e_a = float((a_k - a_p).abs().max())
            errs["folb_scores"] = max(errs["folb_scores"], e_s)
            errs["folb_apply"] = max(errs["folb_apply"], e_a)
            errs["guard_stats"] = max(errs["guard_stats"], e_g)

            eb = g.element_size()
            g1_lib = g1.to(dt)
            w_lib, wt_lib = w.to(dt), wt.to(dt)
            d_t = d.t()
            sb, sb_by = bound_ms(K * D * eb + D * 4 + K * 4, 2 * K * D)
            ab, ab_by = bound_ms(D * 4 + K * D * eb + K * 4 + D * 4,
                                 2 * K * D + D)
            gb, gb_by = bound_ms(2 * K * D * eb + 2 * K * 4, 2 * K * D)
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
                # no single PyTorch call yields both a sum of squares with
                # non-finite lanes zeroed and a per-row finite flag
                "guard_stats": {
                    "max_abs_err": e_g, "bit_identical_repeat": True,
                    "planted": "nan/+inf/-inf in deltas, grads, both",
                    "ms": device_ms(torch,
                                    lambda: K_mod.guard_stats(d, g)),
                    "plain_ms": device_ms(
                        torch, lambda: K_mod.guard_stats_plain(d, g)),
                    "library_ms": None, "library": None,
                    "call_us": host_us(torch,
                                       lambda: K_mod.guard_stats(d, g)),
                    "bound_ms": gb, "bound_by": gb_by},
            }
            emit(row)
            rows.append(row)
    return rows, errs


def folb_want(rounds: int, guarded: bool) -> dict:
    """Launches of an FL run: each FOLB kernel once a round
    (``guard_stats`` only on guarded rounds), no attention or scan."""
    return {"folb_scores": rounds, "folb_apply": rounds,
            "guard_stats": rounds if guarded else 0}


def counted_run(torch, label, want, fn):
    """Run ``fn`` with every launch counter zeroed just before and read
    just after; the counts must equal ``want`` (kernels it leaves out: 0).
    -> (result, counts, secs)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launches()
    want = {name: want.get(name, 0) for name in KERNELS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return res, counts, secs


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def main_path(torch):
    """Phase 4: the port's front door on the card."""
    from repro_torch import fed
    from repro_torch.configs.paper_models import LSTM, MCLR
    from repro_torch.data.federated import stack_devices
    from repro_torch.data.synthetic import char_stream, synthetic_alpha_beta
    from repro_torch.kernels import GuardConfig
    from repro_torch.sysmodel import ScenarioConfig, realize

    lstm_data = stack_devices(char_stream(seed=0, n_devices=20), seed=0)
    lstm_fl = fed.FLConfig(algo="folb", n_selected=10, mu=1.0, lr=0.05,
                           seed=0)
    sc = ScenarioConfig(drop_prob=0.1, nan_prob=0.1, scale_prob=0.1,
                        scale_mag=100.0, seed=0)
    runs = {
        "mclr": (MCLR, stack_devices(synthetic_alpha_beta(
            seed=0, n_devices=30, alpha=1.0, beta=1.0, mean_size=120),
            seed=0),
            fed.FLConfig(algo="folb", n_selected=10, mu=1.0, lr=0.05,
                         seed=0), 20, None),
        "lstm": (LSTM, lstm_data, lstm_fl, 3, None),
        "lstm_guarded": (LSTM, lstm_data, dataclasses.replace(
            lstm_fl, guard=GuardConfig(**GUARD_KW)), 3, sc),
    }
    launches = {name: 0 for name in KERNELS}
    for name, (cfg, data, fl, rounds, scenario) in runs.items():
        res, counts, secs = counted_run(
            torch, name, folb_want(rounds, fl.guard is not None),
            lambda: fed.run(cfg, data, fl, rounds, scenario=scenario))
        losses = res["train_loss"]
        row = {"phase": "main_path", "model": name, "rounds": rounds,
               "n_devices": int(data.x.shape[0]),
               "max_examples": int(data.x.shape[1]),
               "seconds": secs, "seconds_per_round": secs / rounds,
               "launches": counts, "train_loss": losses,
               "test_acc": res["test_acc"]}
        if scenario is not None:
            draws = realize(scenario, (rounds, fl.n_selected))
            n_corrupt = int((draws.corrupt != 1.0).sum())
            row.update(scenario=dataclasses.asdict(scenario),
                       guard=GUARD_KW, corrupted_dispatches=n_corrupt,
                       dropped_dispatches=int(draws.drop.sum()))
            if n_corrupt == 0:
                raise AssertionError(f"{name}: no dispatch was corrupted")
        emit(row)
        for k, n in counts.items():
            launches[k] += n
        if not finite(losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if name == "mclr" and not losses[-1] < losses[0]:
            raise AssertionError(f"MCLR train loss did not fall: {losses}")
    return launches


def guard_phase(torch):
    """Phase 4b: the guard doing its job, at the settings of
    benchmarks/resilience.py, and one corrupted round's counters."""
    from repro_torch import fed
    from repro_torch.configs.paper_models import MCLR
    from repro_torch.data.federated import stack_devices
    from repro_torch.data.synthetic import synthetic_alpha_beta
    from repro_torch.fed import scan_engine, simulator
    from repro_torch.kernels import GuardConfig
    from repro_torch.models import small
    from repro_torch.sysmodel import ScenarioConfig

    data = stack_devices(synthetic_alpha_beta(0, 30, 1.0, 1.0,
                                              mean_size=60), seed=0)
    guard = GuardConfig(**GUARD_KW)
    sc = ScenarioConfig(nan_prob=0.025, scale_prob=0.025, scale_mag=100.0,
                        seed=0)
    base = fed.FLConfig(algo="folb", n_selected=10, mu=1.0, lr=0.05, seed=0)
    rounds = 40
    launches = {name: 0 for name in KERNELS}
    acc = {}
    for name, g, scen in (("clean", None, None), ("unguarded", None, sc),
                          ("guarded", guard, sc)):
        fl = dataclasses.replace(base, guard=g)
        res, counts, secs = counted_run(
            torch, f"resilience {name}", folb_want(rounds, g is not None),
            lambda: fed.run(MCLR, data, fl, rounds, scenario=scen))
        acc[name] = res["test_acc"][-1]
        for k, n in counts.items():
            launches[k] += n
        emit({"phase": "resilience", "run": name, "rounds": rounds,
              "final_test_acc": acc[name],
              "final_train_loss": res["train_loss"][-1],
              "seconds": secs, "seconds_per_round": secs / rounds,
              "launches": counts})
    if not (finite([acc["guarded"]])
            and abs(acc["guarded"] - acc["clean"]) <= RESILIENCE_TOL):
        raise AssertionError(f"guarded accuracy {acc['guarded']} is not "
                             f"within {RESILIENCE_TOL} of clean "
                             f"{acc['clean']}")

    # one corrupted round through fl_round: two NaN rows arrive, one NaN
    # row is dropped in transit, one row is inflated, one sign-flipped
    dev = torch.device("cuda")
    nan = float("nan")
    corrupt = torch.tensor([nan, 1, 100, nan, nan, 1, 1, 1, -1, 1],
                           device=dev)
    up_mask = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
                           dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in small.init_small(MCLR, gen).items()}
    train = scan_engine.device_data(MCLR, data.x, data.y, data.mask, dev)
    ids = torch.arange(10, device=dev)
    steps = torch.as_tensor(simulator.local_step_draws(0, 10, base)).to(dev)
    fl = dataclasses.replace(base, guard=guard)
    (new, diag), counts, _ = counted_run(
        torch, "fl_round", folb_want(1, True),
        lambda: simulator.fl_round(MCLR, fl, params, train, ids, steps,
                                   up_mask=up_mask, corrupt=corrupt))
    for k, n in counts.items():
        launches[k] += n
    ginfo = {k: v.tolist() for k, v in diag["guard"].items()}
    arrived_nan = int((torch.isnan(corrupt) & (up_mask > 0)).sum())
    emit({"phase": "guard_round", "corrupt": corrupt.tolist(),
          "up_mask": up_mask.tolist(), "arrived_nan_rows": arrived_nan,
          "guard": ginfo, "launches": counts})
    if ginfo["n_nonfinite"] != arrived_nan:
        raise AssertionError(f"n_nonfinite {ginfo['n_nonfinite']} != "
                             f"{arrived_nan} NaN rows that arrived")
    if not all(bool(torch.isfinite(v).all()) for v in new.values()):
        raise AssertionError("the guarded round left non-finite params")
    return launches


def against_cpu(torch):
    """Phase 5: the card's run agrees with the port's plain CPU path."""
    from repro_torch import fed
    from repro_torch.configs.paper_models import LSTM, MCLR
    from repro_torch.data.federated import stack_devices
    from repro_torch.data.synthetic import char_stream, synthetic_alpha_beta
    from repro_torch.kernels import GuardConfig
    from repro_torch.sysmodel import ScenarioConfig

    narrow = dataclasses.replace(LSTM, vocab=12, n_classes=12, seq_len=8,
                                 hidden=16, embed=8)
    mclr_data = stack_devices(synthetic_alpha_beta(
        0, 12, 1.0, 1.0, mean_size=40), seed=0)
    lstm_data = stack_devices(char_stream(
        0, 8, vocab=12, seq_len=8, mean_size=20, n_classes=12), seed=0)
    fl = fed.FLConfig(n_selected=4, max_local_steps=5, agg_dtype="float32",
                      seed=1)
    guarded = dataclasses.replace(fl, guard=GuardConfig(**GUARD_KW))
    # seed 26 drops an upload and brings a NaN and an inflated payload in
    # the first two rounds, each outvoted by benign rows, so the guard
    # holds the runs at unit scale, where REF_ATOL is some 100 fp32 ulps
    sc = ScenarioConfig(drop_prob=0.2, nan_prob=0.15, scale_prob=0.15,
                        scale_mag=100.0, seed=26)
    cases = {
        "mclr": (MCLR, mclr_data, fl, None, 3),
        "lstm_narrow": (narrow, lstm_data, fl, None, 2),
        "mclr_guarded_scenario": (MCLR, mclr_data, guarded, sc, 3),
        "lstm_narrow_guarded_scenario": (narrow, lstm_data, guarded, sc, 2),
    }
    for name, (cfg, data, fl, scen, rounds) in cases.items():
        card = fed.run(cfg, data, fl, rounds, scenario=scen)
        cpu = fed.run(cfg, data, fl, rounds, device="cpu", scenario=scen)
        loss_err = max(abs(a - b) for a, b in
                       zip(card["train_loss"], cpu["train_loss"]))
        param_err = max(float((card.params[k].cpu() - cpu.params[k])
                              .abs().max()) for k in cpu.params)
        emit({"phase": "reference", "model": name, "rounds": rounds,
              "train_loss_max_abs_err": loss_err,
              "params_max_abs_err": param_err, "atol": REF_ATOL})
        if not (loss_err <= REF_ATOL and param_err <= REF_ATOL):
            raise AssertionError(f"{name}: card and CPU runs disagree")


def _timed(torch, fn) -> float:
    """Device ms per call of a heavier kernel: fewer calls per batch."""
    return device_ms(torch, fn, per_batch=5, batches=20)


def check_attention(torch):
    """Phase 3b, attention: the kernel against its plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    # (role, B, S, H, KV, d, causal, window, dtype)
    cases = [("zamba2", 4, 512, 32, 32, 80, True, 0, "bfloat16"),
             ("fed100m", 4, 512, 12, 12, 64, True, 0, "float32"),
             ("gqa_window", 2, 1024, 8, 2, 128, True, 256, "bfloat16"),
             ("ragged", 2, 200, 8, 8, 80, True, 0, "float32"),
             ("non_causal", 2, 512, 8, 8, 64, False, 0, "float32"),
             ("d256", 1, 512, 8, 8, 256, True, 0, "bfloat16")]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = []
    for role, B, S, H, KV, d, causal, window, dname in cases:
        dt = getattr(torch, dname)
        q = torch.randn((B, S, H, d), generator=gen).to(dev, dt)
        k = torch.randn((B, S, KV, d), generator=gen).to(dev, dt)
        v = torch.randn((B, S, KV, d), generator=gen).to(dev, dt)
        kw = {"causal": causal, "sliding_window": window}
        out = fa.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        if not err < FLASH_TOL[dname]:
            raise AssertionError(f"flash_attention {role}: max error {err}")
        pos = torch.arange(S, device=dev)
        live = torch.ones((S, S), dtype=torch.bool, device=dev)
        if causal:
            live &= pos[None, :] <= pos[:, None]
        if window:
            live &= pos[None, :] > pos[:, None] - window
        pairs = int(live.sum())
        eb = q.element_size()
        bound, by = bound_ms(eb * (2 * B * S * H * d + 2 * B * S * KV * d),
                             4 * B * H * d * pairs,
                             BF16_FLOP_PER_S if dname == "bfloat16"
                             else FP32_FLOP_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_kw = ({"attn_mask": live} if window
                  else {"is_causal": causal})
        row = {"phase": "kernel", "kernel": "flash_attention", "role": role,
               "B": B, "S": S, "H": H, "KV": KV, "d": d, "causal": causal,
               "window": window, "dtype": dname, "max_abs_err": err,
               "tol": FLASH_TOL[dname],
               "ms": _timed(torch, lambda: fa.flash_attention(q, k, v,
                                                              **kw)),
               "plain_ms": _timed(torch, lambda: flash_attention_ref(
                   q, k, v, **kw)),
               "library_ms": _timed(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, enable_gqa=KV != H, **lib_kw)),
               "library": "torch.nn.functional.scaled_dot_product_attention",
               "call_us": host_us(torch, lambda: fa.flash_attention(
                   q, k, v, **kw), calls=50),
               "bound_ms": bound, "bound_by": by}
        emit(row)
        rows.append(row)
    return rows


def check_ssd(torch):
    """Phase 3b, scan: the kernel against its plain version, y and the
    final state."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssm_scan as ss
    # (role, B, S, H, P, N, chunk): Zamba2 at full width, the reduced
    # model, S = chunk, and N = 128 with the rows of a head on 1, 2 and 4
    # blocks
    cases = [("zamba2", 4, 512, 80, 64, 64, 256),
             ("reduced", 2, 64, 16, 32, 16, 32),
             ("s_eq_chunk", 4, 256, 80, 64, 64, 256),
             ("n128_p64", 2, 256, 4, 64, 128, 64),
             ("n128_p384", 2, 256, 4, 384, 128, 64),
             ("n128_p1024", 2, 256, 4, 1024, 128, 64)]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    rows = []
    for role, B, S, H, P, N, chunk in cases:
        x = torch.randn((B, S, H, P), generator=gen).to(dev)
        loga = -F.softplus(torch.randn((B, S, H), generator=gen)).to(dev)
        w = torch.sigmoid(torch.randn((B, S, H), generator=gen)).to(dev)
        Bm = torch.randn((B, S, 1, N), generator=gen).to(dev)
        Cm = torch.randn((B, S, 1, N), generator=gen).to(dev)
        args = (x, loga, w, Bm, Cm)
        y, h = ss.ssd_scan(*args, chunk=chunk)
        y_p, h_p = ss.ssd_chunked(*args, chunk=chunk)
        torch.testing.assert_close(y, y_p, atol=SSD_ATOL, rtol=SSD_RTOL)
        torch.testing.assert_close(h, h_p, atol=SSD_ATOL, rtol=SSD_RTOL)
        err_y = float((y - y_p).abs().max())
        err_h = float((h - h_p).abs().max())
        n_bytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                       + B * H * P * N)
        bound, by = bound_ms(n_bytes, 5 * B * H * S * P * N)
        row = {"phase": "kernel", "kernel": "ssd_scan", "role": role,
               "B": B, "S": S, "H": H, "P": P, "N": N, "G": 1,
               "chunk": chunk, "dtype": "float32",
               "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
               "max_abs_err_state": err_h, "y_max": float(y_p.abs().max()),
               "atol": SSD_ATOL, "rtol": SSD_RTOL,
               "ms": _timed(torch, lambda: ss.ssd_scan(*args, chunk=chunk)),
               "plain_ms": _timed(torch, lambda: ss.ssd_chunked(
                   *args, chunk=chunk)),
               "library_ms": None, "library": None,
               "call_us": host_us(torch, lambda: ss.ssd_scan(
                   *args, chunk=chunk), calls=50),
               "bound_ms": bound, "bound_by": by}
        emit(row)
        rows.append(row)
    return rows


def check_slstm(torch):
    """Phase 3b, sLSTM: the kernel against its plain version, out and the
    final (h, c, n)."""
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels.ref import slstm_scan_ref
    # (role, B, S, H, dh, dtype): xLSTM-1.3B's sLSTM in bf16 (the serving
    # dtype) and fp32, a prime S at full width, the reduced model
    cases = [("xlstm", 4, 512, 4, 512, "bfloat16"),
             ("xlstm_fp32", 4, 512, 4, 512, "float32"),
             ("prime_s", 4, 127, 4, 512, "float32"),
             ("reduced", 2, 64, 4, 64, "float32")]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    rows = []
    for role, B, S, H, dh, dname in cases:
        dt = getattr(torch, dname)
        xg = torch.randn((B, S, 4 * H * dh), generator=gen).to(dev, dt)
        r = (torch.randn((H, dh, 4 * dh), generator=gen)
             * dh ** -0.5).to(dev, dt)
        out, state = sl.slstm_scan(xg, r, H)
        want, want_state = slstm_scan_ref(xg, r, H)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        errs_state = [float((a - b).abs().max())
                      for a, b in zip(state, want_state)]
        if not (err <= SLSTM_TOL[dname]
                and max(errs_state) <= SLSTM_STATE_TOL):
            raise AssertionError(f"slstm_scan {role}: out error {err}, "
                                 f"(h, c, n) errors {errs_state}")
        eb = xg.element_size()
        # each input read once, each output written once; the operations
        # are the per-step matrix-vector products, 2 B S H dh 4dh, in fp32
        n_bytes = (eb * (B * S * 4 * H * dh + B * S * H * dh)
                   + r.element_size() * H * dh * 4 * dh + 3 * 4 * B * H * dh)
        bound, by = bound_ms(n_bytes, 2 * B * S * H * dh * 4 * dh)
        row = {"phase": "kernel", "kernel": "slstm_scan", "role": role,
               "B": B, "S": S, "H": H, "dh": dh, "d": H * dh,
               "dtype": dname, "max_abs_err": err,
               "max_abs_err_h_c_n": errs_state,
               "atol": SLSTM_TOL[dname], "atol_state": SLSTM_STATE_TOL,
               "c_absmax": float(want_state[1].abs().max()),
               "ms": device_ms(torch, lambda: sl.slstm_scan(xg, r, H),
                               per_batch=2, batches=10),
               "plain_ms": device_ms(torch, lambda: slstm_scan_ref(
                   xg, r, H), per_batch=1, batches=5),
               "library_ms": None, "library": None,
               "bound_ms": bound, "bound_by": by}
        emit(row)
        rows.append(row)
    return rows


def time_mlstm_ssd(torch):
    """Phase 3b, the mLSTM's recurrence: the plain ``ssd_chunked`` at
    xLSTM-1.3B's mLSTM shape (B 4, S 512, H = G = 4, P = dh + 1 = 1025,
    N = dh = 1024, chunk 64), which the model calls directly since
    ``ssd_scan`` does not take it; the kernel must refuse the shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssm_scan as ss
    B, S, H, dh, chunk = 4, 512, 4, 1024, 64
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((B, S, H, dh + 1), generator=gen).to(dev)
    loga = F.logsigmoid(torch.randn((B, S, H), generator=gen)).to(dev)
    w = torch.sigmoid(torch.randn((B, S, H), generator=gen)).to(dev)
    k = (torch.randn((B, S, H, dh), generator=gen) * dh ** -0.5).to(dev)
    q = torch.randn((B, S, H, dh), generator=gen).to(dev)
    try:
        ss.ssd_scan(x, loga, w, k, q, chunk)
    except ValueError:
        pass
    else:
        raise AssertionError("ssd_scan took the mLSTM shape")
    y, h = ss.ssd_chunked(x, loga, w, k, q, chunk)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())):
        raise AssertionError("ssd_chunked at the mLSTM shape: not finite")
    row = {"phase": "plain", "fn": "ssd_chunked", "role": "mlstm", "B": B,
           "S": S, "H": H, "P": dh + 1, "N": dh, "chunk": chunk,
           "dtype": "float32",
           "ms": _timed(torch, lambda: ss.ssd_chunked(x, loga, w, k, q,
                                                      chunk))}
    emit(row)
    return row


def serve_phase(torch):
    """Phase 4c: the serve launcher at full width and depth."""
    from repro_torch.configs import n_params
    from repro_torch.launch import serve
    B, S, G = 4, 512, 16
    launches = {name: 0 for name in KERNELS}
    rows = []
    for arch, want in (("xlstm-1.3b", {"slstm_scan": 6}),
                       ("zamba2-2.7b", {"flash_attention": 9,
                                        "ssd_scan": 54}),
                       ("fed100m", {"flash_attention": 12})):
        torch.cuda.reset_peak_memory_stats()
        res, counts, secs = counted_run(
            torch, f"serve {arch}", want,
            lambda: serve.main(["--arch", arch, "--batch", str(B),
                                "--prompt-len", str(S), "--gen", str(G)]))
        for name in ("prefill_logits", "last_logits"):
            if not bool(torch.isfinite(res[name]).all()):
                raise AssertionError(f"serve {arch}: non-finite {name}")
        cfg = res["cfg"]
        if res["tokens"].shape != (B, G):
            raise AssertionError(f"serve {arch}: tokens "
                                 f"{tuple(res['tokens'].shape)}")
        row = {"phase": "serve", "arch": arch, "n_layers": cfg.n_layers,
               "d_model": cfg.d_model, "n_params": n_params(cfg),
               "dtype": cfg.param_dtype, "batch": B, "prompt_len": S,
               "gen": G, "prefill_s": res["prefill_s"],
               "decode_s": res["decode_s"],
               "decode_steps": res["decode_steps"],
               "decode_tok_per_s": B * res["decode_steps"] / res["decode_s"],
               "decode_ms_per_step": 1e3 * res["decode_s"]
               / res["decode_steps"],
               "seconds_total": secs,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts,
               "prefill_logits_absmax": float(
                   res["prefill_logits"].float().abs().max()),
               "tokens_seq0": res["tokens"][0].tolist()}
        emit(row)
        rows.append(row)
        for k, n in counts.items():
            launches[k] += n
    return rows, launches


def transformer_against_cpu(torch):
    """Phase 5, serving: reduced models in fp32, card vs the port's CPU
    path from the same weights, prefill and 3 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import model

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    for name, cfg in (("xlstm_reduced_g2",
                       get_config("xlstm-1.3b").reduced(n_layers=4)),
                      ("zamba2_reduced_g2",
                       get_config("zamba2-2.7b").reduced(n_layers=4)),
                      ("fed100m_reduced", get_config("fed100m").reduced())):
        gen = torch.Generator().manual_seed(0)
        params = model.init_params(cfg, gen)
        toks = torch.randint(0, cfg.vocab, (2, 67), generator=gen)
        outs = {}
        for where, dev in (("cpu", "cpu"), ("card", "cuda")):
            p = to(params, dev)
            with torch.inference_mode():
                lg, cache = model.prefill(cfg, p, {"tokens": toks[:, :64]
                                                   .to(dev)}, cache_len=67)
                seq = [lg]
                for i in range(64, 67):
                    lg, cache = model.decode_step(cfg, p, cache,
                                                  toks[:, i:i + 1].to(dev))
                    seq.append(lg)
            outs[where] = torch.stack(seq).float().cpu()
        err = float((outs["card"] - outs["cpu"]).abs().max())
        emit({"phase": "reference", "model": name, "prompt": 64,
              "decode_steps": 3, "logits_max_abs_err": err,
              "logits_absmax": float(outs["cpu"].abs().max()),
              "atol": MODEL_ATOL})
        if not err <= MODEL_ATOL:
            raise AssertionError(f"{name}: card and CPU logits differ by "
                                 f"{err}")


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
    build.load_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in build.build_logs.items()}})

    rows, errs = check_kernels(torch, K_mod)
    attn_rows = check_attention(torch)
    ssd_rows = check_ssd(torch)
    slstm_rows = check_slstm(torch)
    time_mlstm_ssd(torch)
    launches = main_path(torch)
    for k, n in guard_phase(torch).items():
        launches[k] += n
    _, serve_launches = serve_phase(torch)
    for k, n in serve_launches.items():
        launches[k] += n
    against_cpu(torch)
    transformer_against_cpu(torch)

    main_row = next(r for r in rows if r["role"] == "lstm"
                    and r["dtype"] == "bfloat16")
    summary = []
    for name in FOLB_KERNELS:
        m = main_row[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": {"K": main_row["K"], "D_pad": main_row["D_pad"],
                      "dtype": main_row["dtype"]}})
    for name, krows, keys in (
            ("flash_attention", attn_rows,
             ("B", "S", "H", "KV", "d", "dtype")),
            ("ssd_scan", ssd_rows, ("B", "S", "H", "P", "N", "dtype")),
            ("slstm_scan", slstm_rows, ("B", "S", "H", "dh", "dtype"))):
        m = next(r for r in krows if r["role"] in ("zamba2", "xlstm"))
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in krows),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "shape": {k: m[k] for k in keys}})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
