"""Graph convolution (Kipf & Welling style) on meshes.

Parity: ``kaolin/ops/gcn.py`` (reference).  Sparse adjacency is a
``jax.experimental.sparse.BCOO``; the layer is a ``flax.linen`` module.
"""

import jax
import jax.numpy as jnp
try:
    import flax.linen as nn
except ImportError:  # optional: only the layer classes need flax
    nn = None
from jax.experimental import sparse as jsparse

__all__ = ['sparse_bmm', 'normalize_adj', 'GraphConv']


def _is_sparse(x):
    return isinstance(x, jsparse.JAXSparse)


def sparse_bmm(sparse_matrix, dense_matrix_batch):
    """Multiply an unbatched sparse ``(M, N)`` matrix with a batched dense
    ``(B, N, P)`` matrix.

    Parity: ``kaolin/ops/gcn.py:24``.
    """
    b, n, p = dense_matrix_batch.shape
    dense = jnp.transpose(dense_matrix_batch, (1, 0, 2)).reshape(n, b * p)
    result = sparse_matrix @ dense
    return jnp.transpose(result.reshape(-1, b, p), (1, 0, 2))


def normalize_adj(adj):
    """Row-normalize an adjacency matrix (sparse or dense).

    Parity: ``kaolin/ops/gcn.py:48``.
    """
    if _is_sparse(adj):
        norm = (adj @ jnp.ones((adj.shape[0], 1)))[:, 0]
        indices = adj.indices
        values = adj.data / norm[indices[:, 0]]
        return jsparse.BCOO((values, indices), shape=adj.shape)
    norm = adj @ jnp.ones((adj.shape[0], 1))
    return adj / norm


if nn is None:
    def _needs_flax(*args, **kwargs):
        raise ImportError('this layer needs flax')

    GraphConv = _needs_flax
else:
    class GraphConv(nn.Module):
        """Graph convolution layer ``D^-1 A H W (+ H W_self)``.

        Parity: ``kaolin/ops/gcn.py:80``.

        Attributes:
            output_dim: output feature dim.
            self_layer: add a separate self-feature linear layer.
            bias: add bias to the linear layers.
        """
        output_dim: int
        self_layer: bool = True
        use_bias: bool = True

        @nn.compact
        def __call__(self, node_feat, adj, normalize_adj=True):
            h = nn.Dense(self.output_dim, use_bias=self.use_bias,
                         kernel_init=nn.initializers.xavier_uniform(),
                         name='linear')(node_feat)
            if _is_sparse(adj):
                result = sparse_bmm(adj, h)
                if normalize_adj:
                    norm = adj @ jnp.ones((adj.shape[0], 1))
                    result = result / norm
            else:
                result = jnp.matmul(adj, h)
                if normalize_adj:
                    norm = jnp.matmul(adj, jnp.ones((adj.shape[0], 1)))
                    result = result / norm
            if self.self_layer:
                result = result + nn.Dense(
                    self.output_dim, use_bias=self.use_bias,
                    kernel_init=nn.initializers.xavier_uniform(),
                    name='linear_self')(node_feat)
            return result
