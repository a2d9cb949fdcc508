"""Parameter / optimizer-state checkpointing.

The reference ships only the Timelapse USD checkpoints
(``kaolin/visualize/timelapse.py``) — geometry snapshots for
visualization.  For training state (model params + optimizer state +
step counters), this module adds checkpointing (SURVEY.md §5):

* :func:`save` / :func:`load` — orbax-backed (async-capable, sharded
  arrays supported, the standard JAX ecosystem path).
* :func:`save_npz` / :func:`load_npz` — dependency-free single-file
  fallback for small models and tests.

Both round-trip arbitrary pytrees of arrays (NamedTuples such as
``InverseRenderParams``, optax states, nested dicts).
"""

import os
import pickle

import numpy as np
import jax

__all__ = ['save', 'load', 'save_npz', 'load_npz', 'latest_step']


def _step_dir(directory, step):
    return os.path.join(directory, f'step_{step:010d}')


def save(directory, pytree, step=0, overwrite=True):
    """Save a pytree checkpoint with orbax.

    Args:
        directory: checkpoint root (created if missing).
        pytree: any pytree of arrays (params, opt state, ...).
        step: training step used to name the checkpoint.
        overwrite: replace an existing checkpoint at this step.
    """
    import orbax.checkpoint as ocp
    path = os.path.abspath(_step_dir(directory, step))
    ckptr = ocp.StandardCheckpointer()
    if overwrite and os.path.exists(path):
        import shutil
        shutil.rmtree(path)
    ckptr.save(path, pytree)
    ckptr.wait_until_finished()
    return path


def load(directory, like, step=None):
    """Restore a pytree checkpoint saved by :func:`save`.

    Args:
        directory: checkpoint root.
        like: a pytree with the target structure/shapes/dtypes (e.g. the
            freshly initialized params) — restored arrays match it.
        step: step to restore; default: latest.
    """
    import orbax.checkpoint as ocp
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {directory!r}')
    path = os.path.abspath(_step_dir(directory, step))
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), like))


def latest_step(directory):
    """Largest step with a checkpoint under ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith('step_'):
            try:
                steps.append(int(name[len('step_'):]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_npz(path, pytree):
    """Single-file .npz checkpoint (flat leaves + pickled treedef)."""
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    arrays = {f'leaf_{i}': np.asarray(x) for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __treedef__=np.frombuffer(
        pickle.dumps(treedef), dtype=np.uint8), **arrays)
    return path


def load_npz(path):
    """Restore a pytree saved by :func:`save_npz`."""
    with np.load(path, allow_pickle=False) as data:
        treedef = pickle.loads(data['__treedef__'].tobytes())
        leaves = [data[f'leaf_{i}']
                  for i in range(len(data.files) - 1)]
    import jax.numpy as jnp
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in leaves])
