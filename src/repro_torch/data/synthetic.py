"""Synthetic federated datasets (numpy), copied from ``repro.data.synthetic``.

``synthetic_alpha_beta`` reproduces the Synthetic(α, β) generator of
Shamir et al. / Li et al. (FedProx) used by the paper: for each device k,
   u_k ~ N(0, α),  b_k ~ N(0, α),   W_k ~ N(u_k, 1),  bias_k ~ N(u_k, 1)
   v_k ~ N(B_k, 1) with B_k ~ N(0, β);  x ~ N(v_k, Σ), Σ_jj = j^{-1.2}
   y = argmax(softmax(W_k x + bias_k)).
``char_stream`` builds Shakespeare-like next-character sequence tasks for
the LSTM model.  Both draw from ``np.random.default_rng(seed)`` in the same
order as the reference, so the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _power_law_sizes(rng, n_devices: int, mean_size: int, alpha: float = 1.5,
                     min_size: int = 10) -> np.ndarray:
    raw = rng.pareto(alpha, n_devices) + 1.0
    sizes = (raw / raw.mean() * mean_size).astype(int)
    return np.maximum(sizes, min_size)


def synthetic_alpha_beta(seed: int, n_devices: int, alpha: float, beta: float,
                         n_features: int = 60, n_classes: int = 10,
                         mean_size: int = 200, iid: bool = False
                         ) -> List[Dict[str, np.ndarray]]:
    """Returns a list of per-device dicts {'x': (n_k, d), 'y': (n_k,)}."""
    rng = np.random.default_rng(seed)
    sizes = _power_law_sizes(rng, n_devices, mean_size)
    diag = np.array([(j + 1) ** -1.2 for j in range(n_features)])

    W_shared = rng.normal(0, 1, (n_features, n_classes))
    b_shared = rng.normal(0, 1, (n_classes,))

    devices = []
    for k in range(n_devices):
        if iid:
            W, b = W_shared, b_shared
            v = np.zeros(n_features)
        else:
            u = rng.normal(0, alpha)
            W = rng.normal(u, 1, (n_features, n_classes))
            b = rng.normal(u, 1, (n_classes,))
            Bk = rng.normal(0, beta)
            v = rng.normal(Bk, 1, n_features)
        x = rng.normal(v, np.sqrt(diag), (int(sizes[k]), n_features))
        logits = x @ W + b
        y = np.argmax(logits, axis=1)
        devices.append({"x": x.astype(np.float32), "y": y.astype(np.int32)})
    return devices


def char_stream(seed: int, n_devices: int, vocab: int = 80, seq_len: int = 80,
                mean_size: int = 50, n_classes: int = 80
                ) -> List[Dict[str, np.ndarray]]:
    """Shakespeare-like next-character prediction: each device (speaking
    role) has a distinct Markov transition style; label = next character."""
    rng = np.random.default_rng(seed)
    sizes = _power_law_sizes(rng, n_devices, mean_size, min_size=5)
    base = rng.dirichlet(np.ones(vocab) * 0.3, size=vocab)
    devices = []
    for k in range(n_devices):
        # device-specific sharpening of the shared transition matrix
        temp = rng.uniform(0.5, 2.0)
        trans = base ** temp
        trans /= trans.sum(axis=1, keepdims=True)
        n_k = int(sizes[k])
        seqs = np.zeros((n_k, seq_len), np.int32)
        labels = np.zeros((n_k,), np.int32)
        for i in range(n_k):
            s = rng.integers(vocab)
            for t in range(seq_len):
                seqs[i, t] = s
                s = rng.choice(vocab, p=trans[s])
            labels[i] = s % n_classes
        devices.append({"x": seqs, "y": labels})
    return devices
