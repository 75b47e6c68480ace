"""Balanced graph-cut metrics and clustering accuracy (port of
``repro.core.metrics``).  cut(C, C-bar) = 1_C^T W 1_{C-bar}: one SpMM with
the one-hot indicator multivector, on the COO backend so the metrics do
not depend on which layouts are built."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.grblas import api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix

_COO = Descriptor(backend="coo")


def _labels(W: SparseMatrix, labels) -> torch.Tensor:
    return torch.as_tensor(np.asarray(labels) if not torch.is_tensor(labels)
                           else labels, device=W.device).long()


def cut_matrix(W: SparseMatrix, labels, k: int) -> torch.Tensor:
    """M[a,b] = sum of edge weights between clusters a and b."""
    H = torch.nn.functional.one_hot(_labels(W, labels), k).to(W.vals.dtype)
    return H.T @ api.mxm(W, H, desc=_COO)


def rcut(W: SparseMatrix, labels, k: int) -> torch.Tensor:
    """RCut = sum_i cut(C_i, C-bar_i) / |C_i|."""
    labels = _labels(W, labels)
    M = cut_matrix(W, labels, k)
    sizes = torch.bincount(labels, minlength=k).to(M.dtype)
    cutv = torch.sum(M, dim=1) - torch.diagonal(M)
    return torch.sum(torch.where(sizes > 0, cutv / torch.clamp(sizes, min=1),
                                 torch.zeros_like(cutv)))


def ncut(W: SparseMatrix, labels, k: int) -> torch.Tensor:
    """NCut = sum_i cut(C_i, C-bar_i) / vol(C_i)."""
    M = cut_matrix(W, labels, k)
    vol = torch.sum(M, dim=1)
    cutv = vol - torch.diagonal(M)
    return torch.sum(torch.where(vol > 0, cutv / torch.clamp(vol, min=1e-12),
                                 torch.zeros_like(cutv)))


def clustering_accuracy(pred, truth, k: int) -> float:
    """Best-permutation accuracy (Hungarian matching on the confusion
    matrix)."""
    from scipy.optimize import linear_sum_assignment

    pred = pred.cpu().numpy() if torch.is_tensor(pred) else np.asarray(pred)
    truth = truth.cpu().numpy() if torch.is_tensor(truth) else np.asarray(truth)
    C = np.zeros((k, k), np.int64)
    np.add.at(C, (pred, truth), 1)
    r, c = linear_sum_assignment(-C)
    return float(C[r, c].sum()) / len(pred)
