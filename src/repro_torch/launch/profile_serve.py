"""Where the serve path's time goes on the card: one prefill and a few
decode steps, each after a warm-up of the same work, timed on the host
clock and then again under ``torch.profiler`` (device activity only);
prints one JSON line per phase with the wall time, the device time, their
ratio (the device's busy share) and the heaviest kernels.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch zamba2-2.7b      (or xlstm-1.3b, fed100m, ...)

at the serving shape of ``chip_smoke.py``: batch 4, prompt 512, 4 decode
steps.

Needs the card: device time is what it measures.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import model as model_lib

B, S, STEPS = 4, 512, 4     # chip_smoke.py's serving shape; decode steps
TOP = 12                    # kernels listed per phase


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _summary(prof, wall_s: float) -> Dict:
    """Device time by kernel (summed over launches), its share of the
    unprofiled wall time, and the heaviest ``TOP`` kernels."""
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_name[evt.name]
            entry[0] += _device_us(evt)
            entry[1] += 1
    total_us = sum(v[0] for v in by_name.values())
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"wall_ms": wall_s * 1e3, "device_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e6 / wall_s,
            "n_kernel_launches": int(sum(v[1] for v in by_name.values())),
            "top": [{"kernel": name[:120], "ms": us / 1e3, "calls": n,
                     "share_of_device": us / max(total_us, 1e-9)}
                    for name, (us, n) in heavy]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    args = ap.parse_args(argv)
    dev = resolve(None)
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, Dict] = {}
    with torch.inference_mode():
        params = model_lib.init_params(cfg, gen)
        prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)

        def prefill():
            return model_lib.prefill(cfg, params, {"tokens": prompt},
                                     cache_len=S + 2 * STEPS)

        def decode(cache):
            toks = prompt[:, :1]
            for _ in range(STEPS):
                _, cache = model_lib.decode_step(cfg, params, cache, toks)
            return cache

        # warm-up; every later decode run starts again from this cache's
        # position (decode_step returns a new dict, its KV writes land in
        # the same slots), so S + 2 x STEPS slots suffice
        cache = decode(prefill()[1])
        for phase, fn in (("prefill", prefill),
                          ("decode", lambda: decode(cache))):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize(dev)
            row = _summary(prof, wall)
            row.update(phase=phase, arch=cfg.name, batch=B, prompt_len=S,
                       steps=STEPS if phase == "decode" else 1,
                       device=torch.cuda.get_device_name(dev))
            print(json.dumps(row), flush=True)
            out[phase] = row
    return out


if __name__ == "__main__":
    main()
