"""The port's data stream and int8 gradient compression against the JAX
package on the CPU, bit for bit.

The threefry2x32 generator on torch integers: ``PRNGKey``, ``fold_in``,
``split`` and ``randint`` equal ``jax.random``'s (jax 0.9.0, partitionable
threefry, as installed), at spans up to past 2**16 where randint's
multiplier wraps in uint32; then ``global_batch_at`` and
``batch_for_shard`` at two seeds and two steps. The compression: the
round trip of ``compress_tree`` and ``decompress_tree`` (the new error
too) on a tree with a layer stack, rounding ties at +-x.5 to even, and
``compressed_psum`` over four shards against the reference's under a
named ``vmap``.

The reference runs op by op here (small programs), in two tests
(ROADMAP.md, test budget)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jdp  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro_torch.convert import model_params_to_numpy  # noqa: E402
from repro_torch.core.shards import ShardAxes  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key).astype(np.int64)


def test_threefry_and_the_token_stream_are_the_references():
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 1234567):
        key, tkey = jax.random.PRNGKey(seed), tdp.PRNGKey(seed)
        np.testing.assert_array_equal(tkey.numpy(), _words(key))
        key, tkey = jax.random.fold_in(key, 77), tdp.fold_in(tkey, 77)
        np.testing.assert_array_equal(tkey.numpy(), _words(key))
        np.testing.assert_array_equal(tdp.split(tkey, 3).numpy(),
                                      _words(jax.random.split(key, 3)))
        for span in (7, 256, 49152, 65536, 163840):
            got = tdp.randint(tkey, (5, 9), 3, 3 + span)
            want = np.asarray(jax.random.randint(key, (5, 9), 3, 3 + span))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=span)
    for seed in (0, 5):
        for step in (0, 13):
            jcfg = jdp.DataConfig(vocab=101, seq_len=16, global_batch=8,
                                  seed=seed)
            tcfg = tdp.DataConfig(vocab=101, seq_len=16, global_batch=8,
                                  seed=seed)
            np.testing.assert_array_equal(
                tdp.global_batch_at(tcfg, step).numpy(),
                np.asarray(jdp.global_batch_at(jcfg, step)))
            for shard in (0, 1):
                got = tdp.batch_for_shard(tcfg, step, shard, 2)
                want = jdp.batch_for_shard(jcfg, step, shard, 2)
                for k in ("tokens", "targets"):
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  np.asarray(want[k]))
    it = tdp.batch_iterator(tdp.DataConfig(101, 16, 8), start_step=3)
    assert [next(it)[0] for _ in range(3)] == [3, 4, 5]


def test_int8_compression_is_the_references():
    rng = np.random.default_rng(0)
    # absmax 127: scale 1, so x.5 values are exact ties, rounded to even
    ties = np.array([127.0, -127.0, 0.5, -0.5, 1.5, -2.5, 2.5], np.float32)
    q, scale = comp.quantize_int8(torch.from_numpy(ties))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(ties))
    assert q.tolist() == [127, -127, 0, 0, 2, -2, 2]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale) == 1.0
    # a tree with a layer stack (one scale over both layers, as the
    # reference's one leaf) and a plain leaf
    grads = {"layers.0.attn.wq": rng.standard_normal((4, 2, 3)),
             "layers.1.attn.wq": 3 * rng.standard_normal((4, 2, 3)),
             "final_norm": rng.standard_normal(4)}
    err = {k: 0.01 * rng.standard_normal(v.shape) for k, v in grads.items()}
    grads, err = ({k: torch.tensor(v, dtype=torch.float32)
                   for k, v in t.items()} for t in (grads, err))
    qt, et = comp.compress_tree(grads, err)
    back = model_params_to_numpy(comp.decompress_tree(qt))
    new_err = model_params_to_numpy(et)
    jg = {k: jnp.asarray(v) for k, v in model_params_to_numpy(grads).items()}
    je = {k: jnp.asarray(v) for k, v in model_params_to_numpy(err).items()}
    jqt, jet = jcomp.compress_tree(jg, je)
    for k, v in jcomp.decompress_tree(jqt).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(new_err[k], np.asarray(jet[k]),
                                      err_msg=k)
    # the int8 all-reduce over four shards
    xs = rng.standard_normal((4, 33)).astype(np.float32)
    xs[2] *= 5
    want = jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(xs))
    got = comp.compressed_psum([torch.from_numpy(x) for x in xs],
                               ShardAxes((torch.device("cpu"),) * 4, 1))
    for s in range(4):
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]))
