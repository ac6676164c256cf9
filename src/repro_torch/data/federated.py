"""Federated dataset container, copied from ``repro.data.federated``.

Pads per-device data to a common size so a whole cohort lives in one
stacked array, with masks for correctness, plus the train/test split and
the device weights p_k = |D_k| / |D| (Sec. II-A).  The port's engines read
only the fields, so the reference's ``FederatedData`` works as well.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class FederatedData:
    """Stacked devices: x (N, M, ...), y (N, M), mask (N, M) with M = max
    device size.  p (N,) are the dataset-size weights."""
    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    p: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    test_mask: np.ndarray

    @property
    def n_devices(self) -> int:
        return self.x.shape[0]


def stack_devices(devices: List[Dict[str, np.ndarray]], test_frac: float = 0.2,
                  seed: int = 0, x_key: str = "x", y_key: str = "y"
                  ) -> FederatedData:
    rng = np.random.default_rng(seed)
    train, test = [], []
    for d in devices:
        n = d[x_key].shape[0]
        idx = rng.permutation(n)
        n_test = max(1, int(n * test_frac)) if n > 1 else 0
        test_idx, train_idx = idx[:n_test], idx[n_test:]
        train.append({"x": d[x_key][train_idx], "y": d[y_key][train_idx]})
        test.append({"x": d[x_key][test_idx], "y": d[y_key][test_idx]})

    def pad_stack(parts):
        m = max(1, max(p["x"].shape[0] for p in parts))
        feat = parts[0]["x"].shape[1:]
        xs = np.zeros((len(parts), m) + feat, parts[0]["x"].dtype)
        ys = np.zeros((len(parts), m), np.int32)
        mk = np.zeros((len(parts), m), np.float32)
        for i, p in enumerate(parts):
            n = p["x"].shape[0]
            xs[i, :n] = p["x"]
            ys[i, :n] = p["y"]
            mk[i, :n] = 1.0
        return xs, ys, mk

    x, y, mask = pad_stack(train)
    tx, ty, tmask = pad_stack(test)
    sizes = mask.sum(axis=1)
    p = sizes / sizes.sum()
    return FederatedData(x=x, y=y, mask=mask, p=p.astype(np.float32),
                         test_x=tx, test_y=ty, test_mask=tmask)
