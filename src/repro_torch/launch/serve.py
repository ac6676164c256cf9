"""Serving launcher (``repro.launch.serve``): batched prefill, then a
greedy (or temperature-sampled) decode loop, of a randomly initialised
model.  Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --prompt-len 512 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --batch 4 --prompt-len 512 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch fed100m \\
      --reduced --device cpu

``main(argv)`` returns the generated tokens, the prefill logits, the last
decode logits and the two timings, so tests and scripts can drive it.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import model as model_lib


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="fed100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    if args.ckpt:
        raise NotImplementedError("checkpoint restore (repro.checkpoint.io) "
                                  "is not ported yet (ROADMAP.md queue 1 "
                                  "#16)")
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    B, S = args.batch, args.prompt_len

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if args.temperature <= 0:
            return logits.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    with torch.inference_mode():
        params = model_lib.init_params(cfg, gen)
        prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model_lib.prefill(cfg, params, {"tokens": prompt},
                                          cache_len=S + args.gen)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        print(f"[serve] prefill {B}x{S}: {prefill_s:.2f}s")
        prefill_logits = logits
        toks = sample(logits)
        generated = [toks]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = model_lib.decode_step(cfg, params, cache, toks)
            toks = sample(logits)
            generated.append(toks)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    print(f"[serve] generated {args.gen} tokens x {B} seqs "
          f"in {decode_s:.2f}s ({args.gen * B / max(decode_s, 1e-9):.1f} "
          f"tok/s)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {out[b].tolist()}")
    return {"cfg": cfg, "tokens": out, "prefill_logits": prefill_logits,
            "last_logits": logits, "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": args.gen - 1}


if __name__ == "__main__":
    main()
