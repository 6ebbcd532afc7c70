"""Write the V1 checkpoint fixture: ``slim_v1.ckpt``, a TF V1 (single
file) checkpoint written by ``tf.compat.v1.train.Saver(write_version=V1)``,
over a few slim Inception-v3 names at depth 0.25 (one of them partitioned
into three slices), an optimizer slot and a global step; and
``expected.npz``, every tensor as TensorFlow reads it back, so the card
machine (which has no TensorFlow) can hold the port's reader to it.

    python tests/data/v1/make_fixture.py
"""

from pathlib import Path

import numpy as np
import tensorflow as tf
from tensorflow.core.protobuf import saver_pb2

HERE = Path(__file__).resolve().parent
PREFIX = HERE / "slim_v1.ckpt"
PARTITIONED = "InceptionV3/Conv2d_2a_3x3/weights"   # [3, 3, 8, 8], three slices


def tensors():
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "InceptionV3/Conv2d_1a_3x3/weights": f32(3, 3, 3, 8),
        "InceptionV3/Conv2d_1a_3x3/BatchNorm/beta": f32(8),
        "InceptionV3/Conv2d_1a_3x3/BatchNorm/moving_mean": f32(8),
        "InceptionV3/Conv2d_1a_3x3/BatchNorm/moving_variance": rng.uniform(0.5, 1.5, 8)
        .astype(np.float32),
        "InceptionV3/Conv2d_1a_3x3/weights/RMSProp": f32(3, 3, 3, 8),
        "InceptionV3/Logits/Conv2d_1c_1x1/biases": f32(15),
        "global_step": np.int64(1234),
    }


def write(prefix, values, partitioned, sharded=False):
    """``values`` and the ``partitioned`` variables (name -> value, each
    saved as three slices of its last axis) as a V1 checkpoint at
    ``prefix``; returns the saved path (a file pattern when sharded)."""
    graph = tf.Graph()
    with graph.as_default():
        for name, v in values.items():
            tf.compat.v1.Variable(v, name=name)
        for name, value in partitioned.items():
            def init(shape_, dtype=None, partition_info=None, value=value):
                off = partition_info.var_offset
                return tf.constant(value[tuple(slice(o, o + n) for o, n in zip(off, shape_))])

            tf.compat.v1.get_variable(
                name, shape=value.shape, dtype=tf.float32, initializer=init,
                partitioner=tf.compat.v1.fixed_size_partitioner(3, axis=value.ndim - 1))
        saver = tf.compat.v1.train.Saver(write_version=saver_pb2.SaverDef.V1, sharded=sharded)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            return saver.save(sess, str(prefix), write_meta_graph=False)


def read_back(path, partitioned=(PARTITIONED,)):
    """Every tensor of the V1 checkpoint at ``path`` as TensorFlow reads it:
    ``tf.train.load_checkpoint`` (which refuses sliced tensors), the
    ``partitioned`` ones through the V1 ``Restore`` op, which reassembles
    them."""
    reader = tf.train.load_checkpoint(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if name in partitioned:
            out[name] = tf.raw_ops.Restore(file_pattern=path, tensor_name=name,
                                           dt=tf.float32).numpy()
        else:
            out[name] = reader.get_tensor(name)
    return out


def main():
    part = np.random.RandomState(1).normal(size=(3, 3, 8, 8)).astype(np.float32)
    path = write(PREFIX, tensors(), {PARTITIONED: part})
    (HERE / "checkpoint").unlink(missing_ok=True)     # the Saver's state file
    np.savez(HERE / "expected.npz", **read_back(path))
    print(f"wrote {path} and expected.npz")


if __name__ == "__main__":
    main()
