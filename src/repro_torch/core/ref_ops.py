"""Pure-NumPy oracles for the Provet ISA templates."""
from __future__ import annotations

import numpy as np


def conv2d_ref(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """img: (C_in,H,W); w: (C_out,C_in,K,K) -> (C_out,H-K+1,W-K+1).

    Cross-correlation (CNN convention), stride 1, valid padding."""
    C_in, H, W = img.shape
    C_out, _, K, _ = w.shape
    H_out, W_out = H - K + 1, W - K + 1
    out = np.zeros((C_out, H_out, W_out), np.float64)
    for j in range(K):
        for i in range(K):
            patch = img[:, j: j + H_out, i: i + W_out]       # (C_in,Ho,Wo)
            out += np.einsum("oc,chw->ohw", w[:, :, j, i], patch)
    return out.astype(np.float32)


def depthwise_ref(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """img: (C,H,W); w: (C,K,K)."""
    C, H, W = img.shape
    K = w.shape[-1]
    outs = [conv2d_ref(img[c: c + 1], w[c][None, None])[0] for c in range(C)]
    return np.stack(outs)


def maxpool_ref(img: np.ndarray, K: int) -> np.ndarray:
    H, W = img.shape
    return img.reshape(H // K, K, W // K, K).max(axis=(1, 3))
