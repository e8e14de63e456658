"""Moving parameters, batch-norm state and whole train states between the
JAX package and the port.

Both keep parameters as nested dicts and lists with the same names and the
same layout (a dense kernel is (in, out)), so conversion is leaf by leaf.
Leaves are named by their ``jax.tree_util.keystr`` path, e.g.
``['encoder']['layers'][0]['kernel']`` — the names of the JAX package's
``.npz`` checkpoints — so a flat mapping of such names loads as well as a
nested tree.  A whole ``TrainState`` is named as JAX names its
``TrainState`` dataclass: ``.params[…]``, ``.model_state[…]``, the Adam
moments and count of ``optax.chain(optax.clip(1.0), optax.adam(lr))`` as
``.opt_state[1][0].mu[…]``, ``.nu[…]`` and ``.count`` (int32; the port
keeps it as a 0-d int32 tensor on the parameters' device; the clip holds
no state), and ``.step`` (int32).  Nothing here imports JAX: the JAX
side hands over numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

_KEY = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(\d+))\]")


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{key!r}]" for key in path)


def flatten(tree: Any, path: tuple = ()) -> dict[str, Any]:
    """{keystr path: leaf} of a nested dict/list tree."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {keystr(path): tree}
    flat: dict[str, Any] = {}
    for key, value in items:
        flat.update(flatten(value, path + (key,)))
    return flat


def _parse(name: str) -> list:
    keys, end = [], 0
    for match in _KEY.finditer(name):
        if match.start() != end:
            raise ValueError(f"not a keystr path: {name!r}")
        end = match.end()
        keys.append(match.group(1) if match.group(2) is None else int(match.group(2)))
    if end != len(name) or not keys:
        raise ValueError(f"not a keystr path: {name!r}")
    return keys


def _lists(node: Any) -> Any:
    """Turn dicts keyed 0..n−1 by int into lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0..n-1")
        return [node[i] for i in range(len(node))]
    return node


def unflatten(flat: Mapping[str, Any]) -> Any:
    """Inverse of :func:`flatten`."""
    root: dict = {}
    for name, leaf in flat.items():
        keys = _parse(name)
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return _lists(root)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Parameters or batch-norm state of the JAX package (a nested tree of
    numpy arrays, or a flat {keystr: array} mapping such as a loaded
    checkpoint) → the port's tree of float32 tensors on ``device``."""
    if isinstance(tree, Mapping) and tree and all(
        isinstance(k, str) and k.startswith("[") for k in tree
    ):
        tree = unflatten(tree)
    return _map(
        lambda leaf: torch.tensor(np.asarray(leaf, np.float32), device=device),
        tree,
    )


def params_to_jax(tree: Any) -> Any:
    """The port's tree of tensors → a nested tree of numpy arrays with the
    same names and layout (``jax.tree.map(jnp.asarray, ...)`` places it)."""
    return _map(lambda t: t.detach().cpu().numpy(), tree)


# The optimiser state's name in JAX's TrainState: the Adam state, the first
# element of the second link of the chain.
_ADAM = ".opt_state[1][0]"


def _map_named(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(keystr name, leaf)``; dicts
    and lists keep their structure, empty ones included."""
    if isinstance(tree, Mapping):
        return {k: _map_named(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(keystr(path), tree)


def _parts(params, model_state, opt_state):
    return ((".params", params), (".model_state", model_state),
            (f"{_ADAM}.mu", opt_state["mu"]), (f"{_ADAM}.nu", opt_state["nu"]))


def train_state_to_jax(params, model_state, opt_state, step) -> dict[str, np.ndarray]:
    """{JAX keystr name: numpy array} of a whole train state, the leaves of
    the JAX package's checkpoints."""
    flat = {  # copies, also of CPU tensors: training goes on in place
        prefix + name: leaf.detach().to("cpu", copy=True).numpy()
        for prefix, tree in _parts(params, model_state, opt_state)
        for name, leaf in flatten(tree).items()
    }
    # the Adam count: a 0-d device tensor in training, an int in tests
    flat[f"{_ADAM}.count"] = np.asarray(int(opt_state["count"]), np.int32)
    flat[".step"] = np.asarray(step, np.int32)
    return flat


def train_state_from_jax(flat: Mapping[str, Any], params, model_state,
                         opt_state):
    """(params, model_state, opt_state, step) from the leaves ``flat`` of a
    JAX-named train state, in the structure, dtypes and devices of the
    templates ``params``, ``model_state`` and ``opt_state``.  Raises on a
    missing leaf or a shape that differs."""

    def load(prefix):
        def leaf(name, like):
            key = prefix + name
            if key not in flat:
                raise KeyError(f"Checkpoint missing leaf {key}")
            stored = np.asarray(flat[key])
            if stored.shape != tuple(like.shape):
                raise ValueError(f"Shape mismatch for {key}: checkpoint "
                                 f"{stored.shape} vs model {tuple(like.shape)}")
            return torch.tensor(stored, dtype=like.dtype, device=like.device)
        return leaf

    trees = [_map_named(load(prefix), tree)
             for prefix, tree in _parts(params, model_state, opt_state)]
    scalars = []
    for key in (f"{_ADAM}.count", ".step"):
        if key not in flat:
            raise KeyError(f"Checkpoint missing leaf {key}")
        scalars.append(int(np.asarray(flat[key])))
    params, model_state, mu, nu = trees
    count = opt_state["count"]
    if isinstance(count, torch.Tensor):
        count = torch.tensor(scalars[0], dtype=count.dtype,
                             device=count.device)
    else:
        count = scalars[0]
    return params, model_state, {"mu": mu, "nu": nu, "count": count}, scalars[1]
