"""Multi-host execution test: 2 CPU processes x 4 virtual devices.

The reference has nothing distributed (SURVEY.md §2.3); this validates
the multi-host path (driver config #5): each process feeds
its host-local view shard, the mesh spans both processes, and the
psum'd loss/gradients must be identical across processes and equal to
the single-process value.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, os.environ['KAOLIN_REPO'])
import jax.numpy as jnp
from kaolin_tpu.parallel import distributed as D
from kaolin_tpu.parallel import multi_view_grad

pid = int(os.environ['PROC_ID'])
D.initialize(coordinator_address=os.environ['COORD'],
             num_processes=2, process_id=pid)
assert D.process_count() == 2
mesh = D.make_global_mesh()
n_global = len(jax.devices())

# deterministic global batch: every process can construct the whole
# thing, then contributes only its host-local slice
rng = np.random.RandomState(0)
xs_global = rng.randn(2 * n_global, 8).astype(np.float32)
w = jnp.asarray(rng.randn(8, 4).astype(np.float32))

per_host = xs_global.reshape(2, -1, 8)[pid]
xs = D.host_local_array(mesh, per_host)

def loss_fn(params, views):
    return jnp.sum((views @ params) ** 2) / (2 * n_global)

step = multi_view_grad(loss_fn, mesh)
loss, grads = jax.jit(step)(w, xs)
out = {'pid': pid,
       'loss': float(loss),
       'gnorm': float(jnp.linalg.norm(grads))}
print('RESULT ' + json.dumps(out), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_psum_matches_single():
    port = _free_port()
    env_base = dict(os.environ)
    env_base.pop('JAX_PLATFORMS', None)
    env_base.update({
        'KAOLIN_REPO': REPO,
        'COORD': f'127.0.0.1:{port}',
        'XLA_FLAGS': '--xla_force_host_platform_device_count=4',
        'JAX_PLATFORMS': 'cpu',
        'JAX_NUM_CPU_DEVICES': '4',
    })
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env['PROC_ID'] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, '-c', _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        for line in out.splitlines():
            if line.startswith('RESULT '):
                r = json.loads(line[len('RESULT '):])
                results[r['pid']] = r
    assert set(results) == {0, 1}
    # both processes see the same psum'd loss/grads
    assert results[0]['loss'] == pytest.approx(results[1]['loss'], rel=1e-6)
    assert results[0]['gnorm'] == pytest.approx(results[1]['gnorm'],
                                                rel=1e-6)

    # single-process ground truth
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    loss = float(np.sum((xs @ w) ** 2) / 16)
    assert results[0]['loss'] == pytest.approx(loss, rel=1e-5)
