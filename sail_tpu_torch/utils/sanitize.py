"""Numeric sanitizers (port of `sail_tpu/utils/sanitize.py`).

A path tracer's counterpart of a race is nondeterminism: a race in a
kernel's sums shows as bits that differ between repeated or re-tiled runs,
which `tools/determinism_check.py` checks on the card with
`assert_bit_equal`.  Its other failure mode is NaN or Inf from a badly
masked singularity: `check_finite` names the tensor that holds one, and
`sanitized()` turns on torch's anomaly mode, which names the backward
operation that made it.
"""
from __future__ import annotations

import contextlib

import torch


def named_tensors(tree, name: str = "") -> list:
    """(path, tensor) for every tensor in a nest of mappings, named tuples,
    tuples and lists: `name.field[0]`-style paths."""
    if isinstance(tree, torch.Tensor):
        return [(name, tree)]
    if isinstance(tree, dict):
        items = [(f"{name}.{k}" if name else str(k), v)
                 for k, v in tree.items()]
    elif hasattr(tree, "_fields"):
        items = [(f"{name}.{k}" if name else k, getattr(tree, k))
                 for k in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"{name}[{i}]", v) for i, v in enumerate(tree)]
    else:
        return []
    return [leaf for path, v in items for leaf in named_tensors(v, path)]


def check_finite(tree, name: str = "tree", raise_error: bool = True) -> list:
    """Every floating tensor in `tree` finite?  Returns [(path, count of
    non-finite values)] of those that are not; with `raise_error` (the
    default) raises FloatingPointError naming the first.  Reads the values
    on the host, so it synchronises with the card: call it between steps,
    not inside one."""
    findings = []
    for path, t in named_tensors(tree, name):
        if t.is_floating_point():
            bad = int((~torch.isfinite(t.detach())).sum())
            if bad:
                findings.append((path, bad))
    if findings and raise_error:
        path, bad = findings[0]
        raise FloatingPointError(f"{path}: {bad} non-finite value(s) "
                                 f"({len(findings)} tensors affected)")
    return findings


@contextlib.contextmanager
def sanitized(check_nan: bool = True):
    """torch's anomaly mode while the block runs: a backward that makes NaN
    raises, naming the forward operation it came from.  For debugging: it
    slows autograd and keeps every forward's traceback."""
    with torch.autograd.detect_anomaly(check_nan=check_nan):
        yield


def assert_bit_equal(a, b, name: str = "") -> None:
    """Every tensor of `a` equal, bit for bit, to the one at the same path
    of `b` (the determinism contract's assertion); raises naming the first
    that differs and how many of its values do."""
    la, lb = named_tensors(a, name), named_tensors(b, name)
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError(f"{name}: different structures")
    for (path, x), (_, y) in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{path}: {tuple(x.shape)} {x.dtype} "
                                 f"against {tuple(y.shape)} {y.dtype}")
        # bits, so that NaN equals the same NaN and -0 differs from +0
        if x.is_floating_point():
            x, y = x.contiguous().view(_INT[x.element_size()]), \
                y.contiguous().view(_INT[y.element_size()])
        if not torch.equal(x, y):
            raise AssertionError(f"{path}: {int((x != y).sum())} differing "
                                 f"values")


_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}
