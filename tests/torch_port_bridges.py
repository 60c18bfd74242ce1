"""Port state_dict -> JAX variables through a `zoo.load.*_state_dict_from_jax`
bridge, for the DARTS / CDARTS / NAS-Bench-201 port tests (the JAX package
has a torch importer only for the retrain network).

`jax_variables_from_port` runs the bridge (JAX -> port) on the JAX model's
variable shapes with every leaf filled with its own index, which tells, for
each port tensor, the JAX leaf it comes from; each port tensor is then put
back with the inverse layout change (a conv kernel OIHW -> HWIO, a Dense
kernel (out, in) -> (in, out)). Every JAX leaf must be reached.
"""
import jax
import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


def jax_variables_from_port(sd, template, bridge, **kw) -> dict:
    """sd: the port's state_dict; template: the JAX model's variables (or
    `jax.eval_shape` of its init); bridge(variables, **kw) -> port names."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, leaf in enumerate(leaves)])
    out = [None] * len(leaves)
    for name, t in bridge(marked, **kw).items():
        if name.endswith("num_batches_tracked"):
            continue
        t = t.numpy()
        i = int(t.flat[0]) - 1
        assert np.all(t == i + 1), name
        v = _np(sd[name]).astype(np.float32)
        if t.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif t.ndim == 2:
            v = v.T
        assert out[i] is None and v.shape == tuple(leaves[i].shape), name
        out[i] = np.ascontiguousarray(v)
    missing = [i for i, v in enumerate(out) if v is None]
    assert not missing, f"{len(missing)} JAX leaves no port tensor reaches"
    return jax.tree_util.tree_unflatten(treedef, out)


def assert_bridge_inverts(sd, variables, bridge, **kw) -> None:
    """bridge(variables) gives back sd, bit for bit (BN counters aside)."""
    back = bridge(variables, **kw)
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert {k for k in back if not k.endswith("num_batches_tracked")} == want
    for k in want:
        assert torch.equal(back[k], sd[k].detach().cpu()), k
