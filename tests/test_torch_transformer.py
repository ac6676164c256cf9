"""The port's transformer zoo (``repro_torch.models``, ``launch.serve``)
against the reference on the CPU, from the same weights carried across by
``convert.from_reference_model``.

Module by module (layers, attention, ssm), then the serving path whole:
the port's ``prefill`` logits against the reference ``forward`` at the
last prompt position, and 4 teacher-forced ``decode_step``s against
``forward`` at those positions, on reduced Zamba2 with one and two
super-groups, fed100m, and StarCoder2 with GQA and a sliding window whose
prompt overruns the window (the ring cache).  Where the reference's own
``prefill`` is right, the port's caches are held against its caches.

The reference's hybrid ``prefill`` leaves the shared block's MLP out, so
with two or more super-groups its logits and caches disagree with its own
``forward``; the port follows ``forward`` and ``decode_step``.  One test
records that fault.

Tolerance: fp32 throughout, logits of magnitude about 4.  ATOL = 1e-4 on
logits and caches; the largest error measured is 3.3e-5 (reduced Zamba2,
two super-groups: the SSD scan is chunked the same way in both packages,
but the einsums sum in other orders).  Modules: 1e-5 at unit scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as rget
from repro.configs import n_params as r_n_params
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models import ssm as rssm
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs import n_params as t_n_params
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)

ATOL = 1e-4
MOD_ATOL = 1e-5
N_DECODE = 4


def _cfgs(arch, extra=None, **reduced):
    """The same reduced config in both packages."""
    r, t = rget(arch).reduced(**reduced), tget(arch).reduced(**reduced)
    if extra:
        r, t = dataclasses.replace(r, **extra), dataclasses.replace(t, **extra)
    return r, t


def _port(tcfg, tree):
    """A reference subtree (jax arrays) -> the port's tensors on the CPU."""
    return convert.from_reference_model(
        tcfg, {"x": jax.tree.map(np.asarray, tree)}, device="cpu")["x"]


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got: torch.Tensor, want, atol=MOD_ATOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=atol, rtol=0)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------ configs

def test_configs_are_copies():
    for arch in ARCHS + ["paper-mclr", "paper-lstm"]:
        r, t = rget(arch), tget(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(t), arch
        if hasattr(r, "reduced"):
            assert dataclasses.asdict(r.reduced()) == \
                dataclasses.asdict(t.reduced())
            assert r_n_params(r) == t_n_params(t)
    assert round(t_n_params(tget("zamba2-2.7b")) / 1e9, 2) == 2.42


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "starcoder2-7b"])
def test_norm_matches(arch):          # rmsnorm, layernorm
    rc, tc = _cfgs(arch)
    p = rlayers.init_norm(rc, None, rc.d_model)
    p = jax.tree.map(lambda a: a + 0.1 * jnp.arange(a.shape[0]) / a.shape[0],
                     p)
    x = _x((2, 5, rc.d_model), 0)
    _close(tlayers.apply_norm(tc, _port(tc, p), torch.from_numpy(x)),
           rlayers.apply_norm(rc, p, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["fed100m", "zamba2-2.7b",
                                  "starcoder2-7b"])
def test_mlp_matches(arch):           # silu, geglu (tanh gelu), gelu
    rc, tc = _cfgs(arch)
    p = rlayers.init_mlp(rc, jax.random.PRNGKey(1), rc.d_model, rc.d_ff)
    x = _x((2, 5, rc.d_model), 1)
    _close(tlayers.apply_mlp(tc, _port(tc, p), torch.from_numpy(x)),
           rlayers.apply_mlp(rc, p, jnp.asarray(x)))


def test_rope_and_logits_match():
    rc, tc = _cfgs("gemma-7b")        # tied embeddings
    x = _x((2, 7, 3, 16), 2)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [5]])
    _close(tlayers.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos)),
           rlayers.apply_rope(rc, jnp.asarray(x), jnp.asarray(pos)))
    params = {"embed": rlayers.init_embed(rc, jax.random.PRNGKey(2))}
    h = _x((2, 3, rc.d_model), 3)
    _close(tlayers.logits_from_hidden(tc, _port(tc, params),
                                      torch.from_numpy(h)),
           rlayers.logits_from_hidden(rc, params, jnp.asarray(h)))
    rc, tc = _cfgs("fed100m")          # untied head
    params = {"lm_head": rlayers.init_linear(rc, jax.random.PRNGKey(3),
                                             rc.d_model, rc.vocab)}
    _close(tlayers.logits_from_hidden(tc, _port(tc, params),
                                      torch.from_numpy(h)),
           rlayers.logits_from_hidden(rc, params, jnp.asarray(h)))


# ---------------------------------------------------------------- attention

STARCODER_GQA = ("starcoder2-7b", {"n_kv_heads": 2})    # GQA + window 64


def test_attend_matches_with_gqa_and_window():
    rc, tc = _cfgs(*STARCODER_GQA)
    hd = rc.resolved_head_dim
    q, k, v = (_x((2, 70, n, hd), 4 + n) for n in (4, 2, 2))
    mask_r = rattn.make_mask(rc, 70, 70)
    mask_t = tattn.make_mask(tc, 70, 70)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_r))
    _close(tattn._attend(tc, *(torch.from_numpy(a) for a in (q, k, v)),
                         mask_t),
           rattn._attend(rc, *(jnp.asarray(a) for a in (q, k, v)), mask_r))


@pytest.mark.parametrize("S,cache_len", [(40, 48), (80, 84)])
def test_prefill_then_decode_attention_matches(S, cache_len):
    """Prompt shorter than the window (full cache), then longer (ring)."""
    rc, tc = _cfgs(*STARCODER_GQA)
    p = rattn.init_attention(rc, jax.random.PRNGKey(5))
    tp = _port(tc, p)
    x = _x((2, S + 3, rc.d_model), S)
    C = rattn.cache_len_for(rc, cache_len)
    assert C == tattn.cache_len_for(tc, cache_len)
    r_out, r_cache = rattn.prefill_attention(
        rc, p, jnp.asarray(x[:, :S]), rattn.init_kv_cache(rc, 2, C))
    t_out, t_cache = tattn.prefill_attention(
        tc, tp, torch.from_numpy(x[:, :S]), tattn.init_kv_cache(tc, 2, C))
    _close(t_out, r_out)
    for name in ("k", "v"):
        _close(t_cache[name], r_cache[name])
    for i in range(S, S + 3):
        r_out, r_cache = rattn.decode_attention(
            rc, p, jnp.asarray(x[:, i:i + 1]), r_cache, jnp.asarray(i))
        t_out, t_cache = tattn.decode_attention(
            tc, tp, torch.from_numpy(x[:, i:i + 1]), t_cache, i)
        _close(t_out, r_out)
        _close(t_cache["k"], r_cache["k"])


# ---------------------------------------------------------------------- ssm

def test_causal_conv_and_pick_chunk_match():
    rc, tc = _cfgs("zamba2-2.7b")
    w, x = _x((4, 24), 6), _x((2, 9, 24), 7)
    _close(tssm._causal_conv(tc, torch.from_numpy(w), torch.from_numpy(x)),
           rssm._causal_conv(rc, jnp.asarray(w), jnp.asarray(x)))
    for S, target in ((512, 256), (40, 32), (37, 32), (7, 256)):
        assert tssm.pick_chunk(S, target) == rssm.pick_chunk(S, target)


def test_mamba2_prefill_and_decode_match():
    rc, tc = _cfgs("zamba2-2.7b")
    p = rssm.init_mamba2(rc, jax.random.PRNGKey(8))
    p = dict(p, A_log=jnp.linspace(-1.0, 1.0, p["A_log"].shape[0]),
             dt_bias=jnp.linspace(-0.5, 0.5, p["dt_bias"].shape[0]))
    tp = _port(tc, p)
    u = 0.5 * _x((2, 40, rc.d_model), 8)
    _close(tssm.mamba2_forward(tc, tp, torch.from_numpy(u[:, :37])),
           rssm.mamba2_forward(rc, p, jnp.asarray(u[:, :37])))
    r_out, r_st = rssm.mamba2_prefill(rc, p, jnp.asarray(u[:, :32]))
    t_out, t_st = tssm.mamba2_prefill(tc, tp, torch.from_numpy(u[:, :32]))
    _close(t_out, r_out)
    for name in ("ssm", "conv"):
        _close(t_st[name], r_st[name])
    for i in range(32, 40):
        r_out, r_st = rssm.mamba2_decode(rc, p, jnp.asarray(u[:, i:i + 1]),
                                         r_st)
        t_out, t_st = tssm.mamba2_decode(tc, tp,
                                         torch.from_numpy(u[:, i:i + 1]),
                                         t_st)
        _close(t_out, r_out)
    _close(t_st["ssm"], r_st["ssm"])


# ----------------------------------------------------------- serving path

CASES = {
    "zamba2_g1": ("zamba2-2.7b", None, {}, 32),
    "zamba2_g2": ("zamba2-2.7b", None, {"n_layers": 4}, 32),
    "fed100m": ("fed100m", None, {}, 32),
    "starcoder2_gqa_window": ("starcoder2-7b", {"n_kv_heads": 2}, {}, 80),
}
# where the reference's prefill is right: its caches are the yardstick
CACHE_CASES = ["zamba2_g1", "fed100m", "starcoder2_gqa_window"]


def _clone(tree):
    """A copy of a port cache (decode writes the tensors in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@functools.lru_cache(maxsize=None)
def _run(case: str):
    """Reference forward / prefill and the port's prefill + 4 decode steps
    on the same weights and tokens (computed once per case)."""
    arch, extra, reduced, S = CASES[case]
    rc, tc = _cfgs(arch, extra, **reduced)
    params = rmodel.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.from_reference_model(
        tc, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, rc.vocab, (2, S + N_DECODE)).astype(np.int32)
    fwd = _np(jax.jit(lambda p, t: rmodel.forward(rc, p, {"tokens": t})[0])(
        params, toks))
    r_logits, r_cache = rmodel.prefill(rc, params, {"tokens": toks[:, :S]},
                                       cache_len=S + N_DECODE)
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        logits, cache = tmodel.prefill(tc, tp, {"tokens": tt[:, :S]},
                                       cache_len=S + N_DECODE)
        prefill_cache = _clone(cache)
        steps = []
        for i in range(S, S + N_DECODE):
            lg, cache = tmodel.decode_step(tc, tp, cache, tt[:, i:i + 1])
            steps.append(lg)
    return {"S": S, "fwd": fwd, "ref_prefill": (_np(r_logits), r_cache),
            "logits": logits, "cache": prefill_cache, "steps": steps,
            "rc": rc}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_match_reference_forward(case):
    r = _run(case)
    _close(r["logits"], r["fwd"][:, r["S"] - 1], atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_reference_forward(case):
    """Teacher-forced: decode step i feeds token S+i and must give
    forward's logits at position S+i."""
    r = _run(case)
    for i, lg in enumerate(r["steps"]):
        _close(lg, r["fwd"][:, r["S"] + i], atol=ATOL)


@pytest.mark.parametrize("case", CACHE_CASES)
def test_prefill_caches_match_reference_prefill(case):
    r = _run(case)
    ref_cache, cache = r["ref_prefill"][1], r["cache"]
    assert cache["pos"] == int(ref_cache["pos"]) == r["S"]
    for l, kv in enumerate(cache["kv"]):
        for name in ("k", "v"):
            _close(kv[name], ref_cache["kv"][name][l], atol=ATOL)
    for g, group in enumerate(cache.get("ssm", [])):
        for j, st in enumerate(group):
            for name in ("ssm", "conv"):
                _close(st[name], ref_cache["ssm"][name][g, j], atol=ATOL)


@pytest.mark.parametrize("case", ["zamba2_g2", "starcoder2_gqa_window"])
def test_decode_from_empty_cache_matches_reference(case):
    """init_cache, then decode_step from position 0, against the
    reference's init_cache and decode_step (no prefill involved)."""
    arch, extra, reduced, _ = CASES[case]
    rc, tc = _cfgs(arch, extra, **reduced)
    params = rmodel.init_params(rc, jax.random.PRNGKey(2))
    tp = convert.from_reference_model(
        tc, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(3).integers(0, rc.vocab, (2, 3))
    r_cache = rmodel.init_cache(rc, 2, 16)
    t_cache = tmodel.init_cache(tc, 2, 16, device="cpu")
    assert t_cache["pos"] == 0
    for i in range(3):
        r_lg, r_cache = rmodel.decode_step(
            rc, params, r_cache, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        with torch.inference_mode():
            t_lg, t_cache = tmodel.decode_step(
                tc, tp, t_cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(t_lg, r_lg, atol=ATOL)


def test_reference_hybrid_prefill_defect_is_not_copied():
    """Known reference fault: with two super-groups the reference's hybrid
    prefill (shared block without its MLP) misses its own forward by far
    more than any rounding; the port's prefill does not."""
    r = _run("zamba2_g2")
    want = r["fwd"][:, r["S"] - 1]
    ref_err = float(np.abs(r["ref_prefill"][0] - want).max())
    port_err = float(np.abs(r["logits"].numpy() - want).max())
    assert ref_err > 0.1 and port_err < ATOL, (ref_err, port_err)


# ----------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "fed100m"])
def test_serve_main_on_cpu_is_greedy_and_consistent(arch, capsys):
    """End to end on the CPU: the generated tokens are the greedy
    continuation that the full-sequence forward gives on the same weights
    and prompt (redrawn from the same seed)."""
    B, S, G = 2, 24, 4
    res = serve.main(["--arch", arch, "--reduced", "--batch", str(B),
                      "--prompt-len", str(S), "--gen", str(G),
                      "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] prefill 2x24" in out and "[serve] generated 4" in out
    toks = res["tokens"]
    assert toks.shape == (B, G) and bool(torch.isfinite(
        res["prefill_logits"]).all()) and res["decode_steps"] == G - 1
    cfg = res["cfg"]
    gen = torch.Generator().manual_seed(3)
    params = tmodel.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    with torch.inference_mode():
        logits = tmodel.forward(cfg, params, {
            "tokens": torch.cat([prompt, toks[:, :-1]], dim=1)})
    assert torch.equal(logits[:, S - 1:].argmax(-1), toks)


def test_serve_defaults_to_the_card_and_refuses_what_is_not_ported():
    argv = ["--reduced", "--batch", "1", "--prompt-len", "8", "--gen", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)
    with pytest.raises(NotImplementedError):
        serve.main(argv + ["--device", "cpu", "--ckpt", "some/dir"])
    for arch in ("mixtral-8x7b", "phi-3-vision-4.2b"):
        with pytest.raises(NotImplementedError):
            serve.main(argv + ["--device", "cpu", "--arch", arch])
    with pytest.raises(ValueError):
        serve.main(argv + ["--device", "cpu", "--arch", "hubert-xlarge"])
    cfg = tget("fed100m").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        tmodel.prefill(cfg, params, {"tokens": torch.zeros((1, 4),
                                                           dtype=torch.long)},
                       quantize_kv=True)
