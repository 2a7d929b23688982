"""Checkpoint / resume for long renders and optimisation runs (PyTorch).

Counterpart of ``fountain_tpu/io/checkpoint.py``, in the same format, so
a file written by either package loads in the other. Every random number
is a counter hash of (lane, sample index), so the whole state of a
partial render is

    (r_sum, g_sum, b_sum, weight_sum, next_sample, spp_total, seed)

plus the parameter tables that an optimisation loop owns; rendering
samples [0, k), a checkpoint, then [k, n) equals [0, n) bit for bit.

Format: one ``.npz`` holding the four film planes, ``meta`` (JSON as
uint8: ``magic``, ``version``, ``next_sample``, ``spp_total``, ``seed``,
``n_params``, ``treedef``) and the parameter leaves ``param_<i>``.

Parameters: a tensor (or array or number), a list or tuple, or a dict,
nested; None holds no leaf. The leaves are stored in the order the JAX
package's ``jax.tree.flatten`` gives them: lists and tuples in order,
dicts by sorted key. ``treedef`` is written in JAX's notation
(``PyTreeDef({'a': *, 'b': [*, *]})``); on load only the leaf count is
checked against ``params_like``, whose structure the leaves refill.
"""
from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import numpy as np
import torch

from fountain_tpu_torch.device import resolve_device
from fountain_tpu_torch.scene.film import Film

_MAGIC = "fountain-tpu-ckpt"
_VERSION = 1


def _flatten(tree: Any, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves``; return its structure in
    JAX's PyTreeDef notation."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure refilled from ``leaves`` (consumed in order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(x, leaves) for x in like]
        return items if isinstance(like, list) else tuple(items)
    return leaves.pop(0)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, film: Film, next_sample: int,
                    spp_total: int, seed: int = 0,
                    params: Any = None) -> None:
    """Write a resumable render checkpoint: the film's sums, the sample
    counters and an optional parameter structure."""
    arrays = {k: _host(getattr(film, k))
              for k in ("r_sum", "g_sum", "b_sum", "weight_sum")}
    meta = {"magic": _MAGIC, "version": _VERSION,
            "next_sample": int(next_sample), "spp_total": int(spp_total),
            "seed": int(seed), "n_params": 0, "treedef": None}
    if params is not None:
        leaves: list = []
        meta["treedef"] = f"PyTreeDef({_flatten(params, leaves)})"
        meta["n_params"] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"param_{i}"] = _host(leaf)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                   dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, params_like: Any = None, device=None
                    ) -> Tuple[Film, int, int, int, Optional[Any]]:
    """Read a checkpoint -> (film, next_sample, spp_total, seed, params).

    The film's planes and the parameter leaves come back as tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU).
    ``params_like`` gives the structure the leaves refill; a leaf count
    that differs raises. Without it the leaves come back as a list (None
    if the checkpoint holds none)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a fountain-tpu checkpoint")
        if meta["version"] > _VERSION:
            raise ValueError(
                f"{path}: checkpoint version {meta['version']} is newer "
                f"than this build ({_VERSION})")
        on_dev = lambda a: torch.as_tensor(np.copy(a), device=dev)  # noqa
        film = Film(*(on_dev(z[k]) for k in
                      ("r_sum", "g_sum", "b_sum", "weight_sum")))
        n = meta["n_params"]
        params: Optional[Any] = None
        if n:
            leaves = [on_dev(z[f"param_{i}"]) for i in range(n)]
            if params_like is not None:
                like: list = []
                _flatten(params_like, like)
                n_like = len(like)
                if n_like != n:
                    raise ValueError(
                        f"{path}: checkpoint has {n} param leaves, "
                        f"params_like has {n_like}")
                params = _unflatten(params_like, leaves)
            else:
                params = leaves
    return (film, meta["next_sample"], meta["spp_total"], meta["seed"],
            params)
