"""Weight bridge between the JAX package's parameter tree and the port's.

Both packages keep the same tree and layouts (``embed.wte [Vp, H]`` with the
padded vocab rows, ``embed.wpe``, ``layers[i].{ln1, attn.{wqkv, bqkv, wo,
bo}, ln2, mlp.{win, bin, wout, bout}}``, an MoE layer's ``moe.{router, win,
wout, shared.{win, bin, wout, bout}, expert_bias}`` in place of ``mlp``,
``prenorm``, ``head`` empty when the head is tied), so the bridge converts
leaves and nothing else: q | k | v
stay in their split order along ``wqkv``'s wide axis and the tied head keeps
reading ``wte``. The JAX side is given as numpy arrays (``layers`` a tuple);
the port's side is fp32 tensors (``layers`` a list).

Saving and loading checkpoints is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]

_NORM = {"scale", "bias"}
_KEYS = {
    "embed": {"wte", "wpe"},
    "attn": {"wqkv", "bqkv", "wo", "bo"},
    "mlp": {"win", "bin", "wout", "bout"},
    "moe": {"router", "win", "wout", "shared", "expert_bias"},
    "head": {"whead"},
}


def _check_keys(tree: Dict, allowed, where: str) -> None:
    extra = set(tree) - set(allowed)
    if extra:
        raise ValueError(f"{where}: keys {sorted(extra)} are outside this "
                         "slice of the port (bert / t5 trees are not "
                         "ported yet)")


def _to_torch(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device,
                        requires_grad=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _map(tree: Dict, fn, where: str, allowed) -> Dict:
    _check_keys(tree, allowed, where)
    return {k: fn(v) for k, v in tree.items()}


def _convert(tree: Params, leaf, layers_type) -> Params:
    _check_keys(tree, {"embed", "layers", "prenorm", "head"}, "params")

    def norm(t, where):
        return _map(t, leaf, where, _NORM)

    def moe(t, where):
        out = _map({k: v for k, v in t.items() if k != "shared"}, leaf,
                   where, _KEYS["moe"])
        if "shared" in t:
            out["shared"] = _map(t["shared"], leaf, f"{where}.shared",
                                 _KEYS["mlp"])
        return out

    layers = []
    for i, lp in enumerate(tree["layers"]):
        ffn = "moe" if "moe" in lp else "mlp"
        _check_keys(lp, {"ln1", "attn", "ln2", ffn}, f"layers[{i}]")
        where = f"layers[{i}].{ffn}"
        layers.append({
            "ln1": norm(lp["ln1"], f"layers[{i}].ln1"),
            "attn": _map(lp["attn"], leaf, f"layers[{i}].attn", _KEYS["attn"]),
            "ln2": norm(lp["ln2"], f"layers[{i}].ln2"),
            ffn: (moe(lp[ffn], where) if ffn == "moe" else
                  _map(lp[ffn], leaf, where, _KEYS["mlp"])),
        })
    return {
        "embed": _map(tree["embed"], leaf, "embed", _KEYS["embed"]),
        "layers": layers_type(layers),
        "prenorm": norm(tree.get("prenorm", {}), "prenorm"),
        "head": _map(tree.get("head", {}), leaf, "head", _KEYS["head"]),
    }


def params_from_jax(tree: Params, device="cpu") -> Params:
    """The JAX package's parameter tree (numpy leaves) -> the port's tree of
    fp32 tensors that require grad."""
    return _convert(tree, lambda x: _to_torch(x, device), list)


def params_to_jax(params: Params) -> Params:
    """The port's tree -> the JAX package's structure with numpy fp32
    leaves (``layers`` a tuple); inverse of :func:`params_from_jax`."""
    return _convert(params, _to_numpy, tuple)
