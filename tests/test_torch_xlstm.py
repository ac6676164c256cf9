"""The port's xLSTM serving path (``repro_torch.models.xlstm``, the xlstm
topology of ``models.model``, ``kernels.slstm_scan``) against the reference
on the CPU, from the same weights and numpy inputs; and the short-prompt
repair of the Mamba2 and mLSTM conv state.

On the CPU ``ops.slstm_scan`` runs its plain version
(``kernels.ref.slstm_scan_ref``), so the kernel tests hold the plain
version, and the dispatch around it, to the reference's Pallas kernel in
interpret mode; the CUDA kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py).

Tolerances, all fp32: the sLSTM scan 1e-5 (the reference kernel test's
bound; the outputs and states are of unit scale), blocks 1e-5 at unit
scale, and the serving path 1e-4 on logits of magnitude about 4 (the
reference agrees with its own ``forward`` to about 1e-5 there).

Prompts of fewer than ``conv_kernel - 1`` tokens crash the reference's
decode (its prefill keeps too few conv rows), so the short-prompt tests
hold the port's prefill and decode to the reference ``forward`` on prompt
and generated tokens instead.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.kernels.slstm_scan import slstm_scan as pallas_slstm
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models import xlstm as rxl
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_scan as tslstm
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as txl

torch.set_num_threads(2)

KERNEL_ATOL = 1e-5
MOD_ATOL = 1e-5
ATOL = 1e-4
N_DECODE = 4
ARCH = "xlstm-1.3b"


def _cfgs(arch=ARCH, **reduced):
    return rget(arch).reduced(**reduced), tget(arch).reduced(**reduced)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: torch.Tensor, want, atol=MOD_ATOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=atol, rtol=0)


def _port(tcfg, tree):
    """A reference subtree (jax arrays) -> the port's tensors on the CPU."""
    return convert.from_reference_model(
        tcfg, {"x": jax.tree.map(np.asarray, tree)}, device="cpu")["x"]


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _slstm_problem(S, seed):
    """Reduced-xLSTM sLSTM params and xg = x @ wx, the same in both."""
    rc, tc = _cfgs()
    p = rxl.init_slstm(rc, jax.random.PRNGKey(0))
    x = _x((2, S, rc.d_model), seed, 0.3)
    xg = rlayers.apply_linear(p["wx"], jnp.asarray(x))
    return rc, tc, p, x, xg


# ------------------------------------------------------------ slstm_scan

@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (128, 64)])
def test_slstm_scan_matches_pallas_interpret(S, chunk):
    rc, _, p, _, xg = _slstm_problem(S, S)
    want = pallas_slstm(xg, p["r"], rc.n_heads, chunk=chunk, interpret=True)
    tslstm.slstm_scan.launches = 0
    out, _ = tops.slstm_scan(_t(xg), _t(p["r"]), rc.n_heads)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert tslstm.slstm_scan.launches == 0          # the CPU: plain version
    _close(out, want, KERNEL_ATOL)


def _cell_scan(cfg, p, xg):
    """The reference model's own recurrence: a scan of ``_slstm_cell``."""
    def step(carry, xg_t):
        h, c, n = rxl._slstm_cell(cfg, p, xg_t, *carry)
        return (h, c, n), h

    zeros = jnp.zeros((xg.shape[0], cfg.d_model), jnp.float32)
    final, hs = jax.lax.scan(step, (zeros,) * 3, jnp.moveaxis(xg, 1, 0))
    return jnp.moveaxis(hs, 0, 1), final


def test_slstm_scan_at_a_prime_length_matches_the_cell_scan():
    """S = 37, which the Pallas kernel cannot take (S % chunk)."""
    rc, _, p, _, xg = _slstm_problem(37, 5)
    want, (h, c, n) = _cell_scan(rc, p, xg)
    out, state = tref.slstm_scan_ref(_t(xg), _t(p["r"]), rc.n_heads)
    _close(out, want, KERNEL_ATOL)
    for got, ref in zip(state, (h, c, n)):
        _close(got, ref, KERNEL_ATOL)


@pytest.mark.parametrize("S", [37, 64])
def test_slstm_final_state_matches_reference_prefill(S):
    rc, tc, p, x, _ = _slstm_problem(S, S + 1)
    r_out, r_state = rxl.slstm_prefill(rc, p, jnp.asarray(x))
    t_out, t_state = txl.slstm_prefill(tc, _port(tc, p), torch.from_numpy(x))
    _close(t_out, r_out)
    for name in ("h", "c", "n"):
        assert t_state[name].dtype == torch.float32
        _close(t_state[name], r_state[name], KERNEL_ATOL)


def test_slstm_scan_rejects_what_it_does_not_take():
    xg, r = torch.zeros((2, 5, 64)), torch.zeros((4, 4, 16))
    assert tops.slstm_scan(xg, r, 4)[0].shape == (2, 5, 16)
    with pytest.raises(ValueError):
        tops.slstm_scan(xg, r, 2)                            # heads
    with pytest.raises(ValueError):
        tops.slstm_scan(xg[:, :, :60], r, 4)                 # width
    with pytest.raises(ValueError):
        tops.slstm_scan(xg.half(), r, 4)                     # dtype
    with pytest.raises(ValueError):
        tops.slstm_scan(xg.to("meta"), r.to("meta"), 4)      # no kernel


# ---------------------------------------------------------------- blocks

def test_mlstm_blocks_match():
    """Forward at a ragged length, prefill, then 8 decode steps."""
    rc, tc = _cfgs()
    p = rxl.init_mlstm(rc, jax.random.PRNGKey(3))
    tp = _port(tc, p)
    u = _x((2, 40, rc.d_model), 3, 0.5)
    _close(txl.mlstm_forward(tc, tp, torch.from_numpy(u[:, :37])),
           rxl.mlstm_forward(rc, p, jnp.asarray(u[:, :37])))
    r_out, r_st = rxl.mlstm_prefill(rc, p, jnp.asarray(u[:, :32]))
    t_out, t_st = txl.mlstm_prefill(tc, tp, torch.from_numpy(u[:, :32]))
    _close(t_out, r_out)
    for name in ("C", "conv"):
        _close(t_st[name], r_st[name])
    for i in range(32, 40):
        r_out, r_st = rxl.mlstm_decode(rc, p, jnp.asarray(u[:, i:i + 1]),
                                       r_st)
        t_out, t_st = txl.mlstm_decode(tc, tp,
                                       torch.from_numpy(u[:, i:i + 1]), t_st)
        _close(t_out, r_out)
    _close(t_st["C"], r_st["C"])


def test_slstm_blocks_match():
    """Forward, prefill, then 8 decode steps from the prefill state."""
    rc, tc = _cfgs()
    p = rxl.init_slstm(rc, jax.random.PRNGKey(4))
    tp = _port(tc, p)
    x = _x((2, 40, rc.d_model), 4, 0.5)
    _close(txl.slstm_forward(tc, tp, torch.from_numpy(x[:, :37])),
           rxl.slstm_forward(rc, p, jnp.asarray(x[:, :37])))
    _, r_st = rxl.slstm_prefill(rc, p, jnp.asarray(x[:, :32]))
    _, t_st = txl.slstm_prefill(tc, tp, torch.from_numpy(x[:, :32]))
    for i in range(32, 40):
        r_out, r_st = rxl.slstm_decode(rc, p, jnp.asarray(x[:, i:i + 1]),
                                       r_st)
        t_out, t_st = txl.slstm_decode(tc, tp,
                                       torch.from_numpy(x[:, i:i + 1]), t_st)
        _close(t_out, r_out)
    for name in ("h", "c", "n"):
        _close(t_st[name], r_st[name])


# ----------------------------------------------------------- serving path

CASES = {"xlstm_g1": {}, "xlstm_g2": {"n_layers": 4}}
S_PROMPT = 32


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _weights(rc, tc, seed):
    params = rmodel.init_params(rc, jax.random.PRNGKey(seed))
    return params, convert.from_reference_model(
        tc, jax.tree.map(np.asarray, params), device="cpu")


def _forward(rc, params, toks) -> np.ndarray:
    return _np(jax.jit(lambda p, t: rmodel.forward(rc, p, {"tokens": t})[0])(
        params, toks))


def _serve(tc, tp, toks: np.ndarray, S: int):
    """The port's prefill of toks[:, :S], then teacher-forced decode of the
    rest -> (prefill logits, prefill cache, decode logits)."""
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        logits, cache = tmodel.prefill(tc, tp, {"tokens": tt[:, :S]},
                                       cache_len=toks.shape[1])
        prefill_cache = _clone(cache)
        steps = []
        for i in range(S, toks.shape[1]):
            lg, cache = tmodel.decode_step(tc, tp, cache, tt[:, i:i + 1])
            steps.append(lg)
    return logits, prefill_cache, steps


@functools.lru_cache(maxsize=None)
def _run(case: str):
    rc, tc = _cfgs(**CASES[case])
    params, tp = _weights(rc, tc, 0)
    toks = np.random.default_rng(1).integers(
        0, rc.vocab, (2, S_PROMPT + N_DECODE)).astype(np.int32)
    _, r_cache = rmodel.prefill(rc, params,
                                {"tokens": jnp.asarray(toks[:, :S_PROMPT])},
                                cache_len=S_PROMPT + N_DECODE)
    logits, cache, steps = _serve(tc, tp, toks, S_PROMPT)
    return {"fwd": _forward(rc, params, toks), "ref_cache": r_cache,
            "logits": logits, "cache": cache, "steps": steps, "tc": tc}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_match_reference_forward(case):
    r = _run(case)
    _close(r["logits"], r["fwd"][:, S_PROMPT - 1], ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_reference_forward(case):
    r = _run(case)
    assert len(r["steps"]) == N_DECODE
    for i, lg in enumerate(r["steps"]):
        _close(lg, r["fwd"][:, S_PROMPT + i], ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_caches_match_reference_prefill(case):
    r = _run(case)
    ref, cache, tc = r["ref_cache"], r["cache"], r["tc"]
    assert cache["pos"] == int(ref["pos"]) == S_PROMPT
    assert len(cache["mlstm"]) == len(cache["slstm"]) == \
        tc.n_super_groups()
    for g, group in enumerate(cache["mlstm"]):
        assert len(group) == tc.xlstm.slstm_every - 1
        for j, st in enumerate(group):
            for name in ("C", "conv"):
                _close(st[name], ref["mlstm"][name][g, j], ATOL)
        for name in ("h", "c", "n"):
            _close(cache["slstm"][g][name], ref["slstm"][name][g], ATOL)


def test_decode_from_empty_cache_matches_reference():
    """init_cache, then decode_step from position 0, against the
    reference's init_cache and decode_step (two super-groups)."""
    rc, tc = _cfgs(n_layers=4)
    params, tp = _weights(rc, tc, 2)
    toks = np.random.default_rng(3).integers(0, rc.vocab, (2, 3))
    r_cache = rmodel.init_cache(rc, 2, 16)
    t_cache = tmodel.init_cache(tc, 2, 16, device="cpu")
    for i in range(3):
        r_lg, r_cache = rmodel.decode_step(
            rc, params, r_cache, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        with torch.inference_mode():
            t_lg, t_cache = tmodel.decode_step(
                tc, tp, t_cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(t_lg, r_lg, ATOL)
    assert t_cache["pos"] == 3


# ---------------------------------------------------------- short prompts

@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", ARCH])
def test_short_prompt_prefill_and_decode_match_reference_forward(arch, S):
    """A prompt of fewer than conv_kernel - 1 tokens: the conv state is
    left-padded with zeros, so prefill and the decode steps after it give
    the reference forward's logits, and the cache equals the one that
    init_cache plus token-by-token decode reaches."""
    rc, tc = _cfgs(arch)
    params, tp = _weights(rc, tc, 5)
    toks = np.random.default_rng(S).integers(
        0, rc.vocab, (2, S + N_DECODE)).astype(np.int32)
    fwd = _forward(rc, params, toks)
    logits, cache, steps = _serve(tc, tp, toks, S)
    _close(logits, fwd[:, S - 1], ATOL)
    for i, lg in enumerate(steps):
        _close(lg, fwd[:, S + i], ATOL)

    stepped = tmodel.init_cache(tc, 2, S + N_DECODE, device="cpu")
    with torch.inference_mode():
        for i in range(S):
            _, stepped = tmodel.decode_step(
                tc, tp, stepped, torch.from_numpy(toks[:, i:i + 1]).long())
    key, names = (("mlstm", ("C", "conv")) if arch == ARCH
                  else ("ssm", ("ssm", "conv")))
    for group, want_group in zip(cache[key], stepped[key]):
        for st, want in zip(group, want_group):
            for name in names:
                assert st[name].shape == want[name].shape
                torch.testing.assert_close(st[name], want[name],
                                           atol=MOD_ATOL, rtol=0)


# --------------------------------------------------------------- launcher

def test_serve_main_on_cpu_is_greedy_and_consistent(capsys):
    """serve.main for reduced xLSTM on the CPU: the generated tokens are
    the greedy continuation that forward gives on the same weights and
    prompt (redrawn from the same seed)."""
    B, S, G = 2, 24, 4
    res = serve.main(["--arch", ARCH, "--reduced", "--batch", str(B),
                      "--prompt-len", str(S), "--gen", str(G),
                      "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] prefill 2x24" in out and "[serve] generated 4" in out
    toks, cfg = res["tokens"], res["cfg"]
    assert toks.shape == (B, G) and res["decode_steps"] == G - 1
    assert bool(torch.isfinite(res["prefill_logits"]).all())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        tget(ARCH).reduced())
    gen = torch.Generator().manual_seed(3)
    params = tmodel.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    with torch.inference_mode():
        logits = tmodel.forward(cfg, params, {
            "tokens": torch.cat([prompt, toks[:, :-1]], dim=1)})
    assert torch.equal(logits[:, S - 1:].argmax(-1), toks)
