"""The PyTorch port's request cache, ported from the first three tests of
tests/test_request_cache.py (its tokenizer and corpus tests wait for the
port's data package), plus its keys' parity with the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.serving import request_cache as jrequest_cache  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.request_cache import (PredictionCache,  # noqa: E402
                                               row_key)
from repro_torch.serving.system import InferenceSystem  # noqa: E402

SEQ = 16


def test_cache_hits_and_order():
    class FakeSystem:
        calls = []

        def predict(self, X):
            FakeSystem.calls.append(X.shape[0])
            return X.sum(axis=1, keepdims=True).astype(np.float32)

    cache = PredictionCache(capacity=100)
    sys_ = FakeSystem()
    X1 = np.arange(12, dtype=np.int32).reshape(4, 3)
    Y1 = cache.predict_through(sys_, X1)
    np.testing.assert_array_equal(Y1[:, 0], X1.sum(1))
    assert cache.misses == 4 and cache.hits == 0

    # repeat 2 rows + 1 new: only the new row goes through
    X2 = np.vstack([X1[1], X1[3], np.array([9, 9, 9], np.int32)])
    Y2 = cache.predict_through(sys_, X2)
    np.testing.assert_array_equal(Y2[:, 0], X2.sum(1))
    assert cache.hits == 2
    assert FakeSystem.calls == [4, 1]


def test_cache_lru_eviction():
    class Echo:
        def predict(self, X):
            return X.astype(np.float32)

    cache = PredictionCache(capacity=2)
    cache.predict_through(Echo(), np.array([[1], [2], [3]], np.int32))
    assert cache.misses == 3
    cache.predict_through(Echo(), np.array([[1]], np.int32))   # evicted
    assert cache.misses == 4


def test_cache_with_real_system():
    cfgs = ensemble("ENS4")[:1]
    jparams = M.init_params(jax.random.PRNGKey(0), jensemble("ENS4")[0])
    params = [params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")]
    alloc = AllocationMatrix(host_cpus(1, memory_bytes=4 * 1024 ** 3),
                             [cfgs[0].name], np.array([[8]]))
    X = np.random.default_rng(0).integers(0, 512, (10, SEQ)).astype(np.int32)
    with InferenceSystem(cfgs, params, alloc, segment_size=16,
                         max_seq=SEQ) as system:
        cache = PredictionCache()
        Y1 = cache.predict_through(system, X)
        Y2 = cache.predict_through(system, X)       # fully cached
    np.testing.assert_array_equal(Y1, Y2)
    assert cache.hits == 10


@pytest.mark.parametrize("dtype,shape", [(np.int32, (16,)),
                                         (np.int32, (3, 5)),
                                         (np.int64, (16,))])
def test_row_keys_match_the_jax_package(dtype, shape):
    """A row hashes to the same key in both packages, so a cache is keyed
    alike whichever package filled it."""
    row = np.random.default_rng(5).integers(0, 512, shape).astype(dtype)
    assert row_key(row) == jrequest_cache.row_key(row)
    jcache = jrequest_cache.PredictionCache()
    X = row.reshape(1, -1)
    jcache.insert(X, np.ones((1, 3), np.float32), salt=b"s")
    cache = PredictionCache()
    cache._store.update(jcache._store)        # entries the JAX cache wrote
    hit, misses = cache.lookup(X, salt=b"s")
    assert misses == [] and hit[0].shape == (3,)
