"""The port as a package: it imports neither jax nor the JAX package, its
numpy copies of the reference's data generators produce the same arrays,
its entry points default to the card, and reference parameters carry
across unchanged."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_models as rpm
from repro.data import federated as rfederated
from repro.data import synthetic as rsynthetic
from repro.models import small as rsmall
from repro_torch import convert, device
from repro_torch.configs import paper_models as tpm
from repro_torch.data import federated as tfederated
from repro_torch.data import synthetic as tsynthetic

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_no_reference():
    code = ("import sys; import repro_torch.fed, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.sysmodel.scenario, "
            "repro_torch.kernels.guard, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.ssm_scan, repro_torch.kernels.slstm_scan, "
            "repro_torch.models.model, repro_torch.models.xlstm, "
            "repro_torch.launch.serve, repro_torch.launch.profile_serve, "
            "repro_torch.configs; "
            "import repro_torch.configs as c; [c.get_config(a) for a in "
            "c.ARCHS]; bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(SRC))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("iid", [False, True])
def test_synthetic_alpha_beta_same_arrays(iid):
    a = rsynthetic.synthetic_alpha_beta(3, 7, 1.0, 0.5, mean_size=30, iid=iid)
    b = tsynthetic.synthetic_alpha_beta(3, 7, 1.0, 0.5, mean_size=30, iid=iid)
    assert len(a) == len(b) == 7
    for da, db in zip(a, b):
        for k in ("x", "y"):
            assert da[k].dtype == db[k].dtype
            np.testing.assert_array_equal(da[k], db[k])


def test_char_stream_same_arrays():
    a = rsynthetic.char_stream(4, 5, vocab=20, seq_len=10, mean_size=8,
                               n_classes=20)
    b = tsynthetic.char_stream(4, 5, vocab=20, seq_len=10, mean_size=8,
                               n_classes=20)
    for da, db in zip(a, b):
        np.testing.assert_array_equal(da["x"], db["x"])
        np.testing.assert_array_equal(da["y"], db["y"])


def test_stack_devices_same_container():
    devs = rsynthetic.synthetic_alpha_beta(5, 6, 1.0, 1.0, mean_size=25)
    a = rfederated.stack_devices(devs, seed=1)
    b = tfederated.stack_devices(devs, seed=1)
    assert b.n_devices == a.n_devices
    for f in ("x", "y", "mask", "p", "test_x", "test_y", "test_mask"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert ga.dtype == gb.dtype
        np.testing.assert_array_equal(ga, gb)


def test_paper_model_configs_are_copies():
    for name in ("MCLR", "MLP", "LSTM"):
        r, t = getattr(rpm, name), getattr(tpm, name)
        assert r.__dict__ == t.__dict__


def test_from_reference_keeps_names_and_values():
    params = jax.tree.map(np.asarray, rsmall.init_small(
        rpm.LSTM, jax.random.PRNGKey(0)))
    got = convert.from_reference(params, device="cpu")
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v)
        got[k].add_(1.0)                  # a copy, not a view
        assert not np.array_equal(got[k].numpy(), v)


def test_resolve_cpu_and_default():
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device.resolve(None)
        with pytest.raises(RuntimeError):
            convert.from_reference({"w": np.zeros(2, np.float32)})
