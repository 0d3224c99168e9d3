"""The port's reader of TensorFlow's V2 checkpoint bundle
(``axcnn_torch.ckpt.tf_bundle``) and its vectorised CRC32C
(``axcnn_torch.data.tfrecord.crc32c``), on the CPU.

TensorFlow writes the fixtures (``tf.raw_ops.SaveV2`` eagerly, two shards
through ``MergeV2Checkpoints``, and a graph ``Saver``); every tensor the
reader gives must equal ``tf.train.load_checkpoint``'s exactly (tolerance
0: both copy the stored bytes). The CRC32C must equal the byte loop
exactly, and TFRecords must keep their bytes.
"""

import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from axcnn.data import tfrecord as j_tfrecord
from axcnn_torch.ckpt import tf_bundle
from axcnn_torch.ckpt.tf_bundle import BundleReader, CorruptBundleError
from axcnn_torch.data import tfrecord as t_tfrecord


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


# -- CRC32C -------------------------------------------------------------------

# 0 and 1 byte, odd lengths, the lanes' threshold, lane counts at and around
# whole lanes for the small and the large lane widths, a megabyte plus a tail
CRC_LENGTHS = [0, 1, 3, 7, 255, 1023, 1024, 1025, 1027, 4095, 4096, 4097, 65535, 65536,
               65537, 262_143, (1 << 20) + 3]


@pytest.mark.parametrize("n", CRC_LENGTHS)
def test_crc32c_equals_the_byte_loop(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert t_tfrecord.crc32c(data) == t_tfrecord.crc32c_bytewise(data)
    assert t_tfrecord.crc32c(bytearray(data)) == t_tfrecord.crc32c_bytewise(data)


def test_crc32c_check_value():
    """The Castagnoli check value (RFC 3720) and a run of zeros."""
    assert t_tfrecord.crc32c(b"123456789") == 0xE3069283
    assert t_tfrecord.crc32c(bytes(5000)) == t_tfrecord.crc32c_bytewise(bytes(5000))


@settings(max_examples=40, deadline=None, database=None)
@given(st.binary(min_size=0, max_size=12_000))
def test_crc32c_equals_the_byte_loop_on_random_data(data):
    assert t_tfrecord.crc32c(data) == t_tfrecord.crc32c_bytewise(data)


def test_tfrecords_keep_their_bytes(tf, tmp_path):
    """Records of 0 B to 300 kB from the port's writer equal the byte-loop
    writer's (the reference's) and TensorFlow's, byte for byte, and read
    back with their CRCs checked; a flipped payload byte raises."""
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (0, 10, 1023, 5000, 65_536, 300_001)]
    paths = {k: str(tmp_path / k) for k in ("port", "reference", "tf")}
    for mod, key in ((t_tfrecord, "port"), (j_tfrecord, "reference")):
        with mod.TFRecordWriter(paths[key]) as w:
            for p in payloads:
                w.write(p)
    with tf.io.TFRecordWriter(paths["tf"]) as w:
        for p in payloads:
            w.write(p)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["reference"] == raw["tf"]
    assert list(t_tfrecord.TFRecordReader(paths["port"], verify_crc=True)) == payloads
    bad = bytearray(raw["port"])
    bad[-100] ^= 1  # inside the last payload
    (tmp_path / "bad").write_bytes(bytes(bad))
    with pytest.raises(IOError, match="payload CRC mismatch"):
        list(t_tfrecord.TFRecordReader(str(tmp_path / "bad"), verify_crc=True))


# -- the bundle reader against TensorFlow ------------------------------------

def _values():
    rng = np.random.default_rng(1)
    return {
        "float32": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "float64": rng.standard_normal(7),
        "float16": rng.standard_normal((2, 3)).astype(np.float16),
        "int32": rng.integers(-2 ** 31, 2 ** 31, 9).astype(np.int32),
        "int64": np.array(-(2 ** 40) - 3, np.int64),  # a scalar
        "bool": rng.integers(0, 2, (4, 2)).astype(bool),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(2.5),
    }


# names long enough, and without shared prefixes, that TF's index spans more
# than one data block
N_LONG = 1400


def _long_names():
    rng = np.random.default_rng(2)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, 200)) for _ in range(N_LONG)]


def _data_blocks(index):
    """The index block's entries: a separator key and a data block's handle
    each."""
    footer = index[-tf_bundle.FOOTER_BYTES:]
    _, pos = tf_bundle._handle(footer, 0)
    handle, _ = tf_bundle._handle(footer, pos)
    return list(tf_bundle._block_entries(tf_bundle._block(index, handle, "x"), "x"))


@pytest.fixture(scope="module")
def bundles(tf, tmp_path_factory):
    """``merged``: two SaveV2 bundles merged into one of two shards, every
    mapped dtype (bfloat16 too), scalars, a zero-size tensor and N_LONG long
    names; ``saver``: a graph ``Saver`` checkpoint of two steps."""
    tmp = tmp_path_factory.mktemp("bundles")
    values = _values()
    tensors = {k: tf.constant(v) for k, v in values.items()}
    tensors["bfloat16"] = tf.cast(tf.constant(
        np.random.default_rng(3).standard_normal((5, 2)).astype(np.float32)), tf.bfloat16)
    for i, name in enumerate(_long_names()):
        tensors[name] = tf.constant(np.float32(i))
    names = sorted(tensors)
    half = len(names) // 2
    for part, chunk in (("a", names[:half]), ("b", names[half:])):
        tf.raw_ops.SaveV2(prefix=str(tmp / part), tensor_names=chunk,
                          shape_and_slices=[""] * len(chunk),
                          tensors=[tensors[n] for n in chunk])
    tf.raw_ops.MergeV2Checkpoints(checkpoint_prefixes=[str(tmp / "a"), str(tmp / "b")],
                                  destination_prefix=str(tmp / "merged"))
    saver_dirs = {}
    for relative in (False, True):
        d = tmp / f"saver_{'relative' if relative else 'absolute'}"
        with tf.Graph().as_default():
            v = tf.compat.v1.get_variable("resnet_model/conv2d/kernel",
                                          initializer=tf.constant(values["float32"]))
            step = tf.compat.v1.train.get_or_create_global_step()
            saver = tf.compat.v1.train.Saver(save_relative_paths=relative)
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                saver.save(sess, str(d / "model.ckpt"), global_step=3)
                sess.run([v.assign(2 * v), step.assign(7)])
                saver.save(sess, str(d / "model.ckpt"), global_step=7)
        saver_dirs[relative] = str(d)
    return dict(merged=str(tmp / "merged"), saver=saver_dirs, tmp=tmp)


def _assert_same_as_tf(tf, reader, path):
    want = tf.train.load_checkpoint(path)
    assert reader.get_variable_to_shape_map() == want.get_variable_to_shape_map()
    assert reader.get_variable_to_dtype_map() == {
        k: v.name for k, v in want.get_variable_to_dtype_map().items()}
    for name in want.get_variable_to_shape_map():
        expected = np.asarray(want.get_tensor(name))
        if expected.dtype.name == "bfloat16":
            expected = expected.astype(np.float32)  # exact: bf16 widens to fp32
        got = reader.get_tensor(name)
        assert got.dtype == expected.dtype and got.shape == expected.shape, name
        np.testing.assert_array_equal(got, expected, err_msg=name)


def test_reader_equals_tf_on_two_shards_and_a_multi_block_index(tf, bundles):
    reader = BundleReader(bundles["merged"])
    assert reader.num_shards == 2
    assert len(_data_blocks(open(bundles["merged"] + ".index", "rb").read())) > 1
    dtypes = set(reader.get_variable_to_dtype_map().values())
    assert dtypes == {"float32", "float64", "float16", "bfloat16", "int32", "int64", "bool"}
    assert len(reader.get_variable_to_shape_map()) == len(_values()) + 1 + N_LONG
    _assert_same_as_tf(tf, reader, bundles["merged"])
    assert reader.get_tensor("empty").shape == (0, 3)
    assert reader.get_tensor("int64").shape == ()


@pytest.mark.parametrize("relative", [False, True], ids=["absolute", "relative"])
def test_reader_resolves_a_saver_directory(tf, bundles, relative):
    """A ``Saver`` checkpoint found through its directory's ``checkpoint``
    file (absolute or relative paths): the newest step, as
    ``tf.train.latest_checkpoint`` finds it."""
    d = bundles["saver"][relative]
    reader = BundleReader(d)
    assert reader.prefix.endswith("model.ckpt-7")
    assert os.path.abspath(reader.prefix) == os.path.abspath(tf.train.latest_checkpoint(d))
    assert int(reader.get_tensor("global_step")) == 7
    _assert_same_as_tf(tf, reader, d)
    with pytest.raises(FileNotFoundError, match="no 'checkpoint' state file"):
        BundleReader(str(bundles["tmp"]))


def _copy_bundle(src, dst):
    for suffix in (".index", ".data-00000-of-00002", ".data-00001-of-00002"):
        with open(src + suffix, "rb") as f:
            data = f.read()
        with open(dst + suffix, "wb") as f:
            f.write(data)


def test_a_flipped_byte_raises(bundles, tmp_path):
    """A byte flipped in a tensor's data raises when that tensor is read; a
    byte flipped in the index's data block raises when the bundle is
    opened; so does a flipped footer magic."""
    good = BundleReader(bundles["merged"])
    prefix = str(tmp_path / "bad")
    _copy_bundle(bundles["merged"], prefix)
    name = "float32"
    entry = good._entries[name]
    path = f"{prefix}.data-{entry.shard:05d}-of-00002"
    data = bytearray(open(path, "rb").read())
    data[entry.offset + 5] ^= 0x10
    open(path, "wb").write(bytes(data))
    bad = BundleReader(prefix)
    np.testing.assert_array_equal(bad.get_tensor("int32"), good.get_tensor("int32"))
    with pytest.raises(CorruptBundleError, match=f"CRC mismatch in {name}"):
        bad.get_tensor(name)
    for where, match in ((100, "CRC mismatch in the block"), (-1, "bad magic")):
        _copy_bundle(bundles["merged"], prefix)
        index = bytearray(open(prefix + ".index", "rb").read())
        index[where] ^= 0x01
        open(prefix + ".index", "wb").write(bytes(index))
        with pytest.raises(CorruptBundleError, match=match):
            BundleReader(prefix)


def test_refusals(tf, bundles, tmp_path):
    """Refused by name: a V1 checkpoint; a partitioned variable, a string
    tensor and an unmapped dtype when asked for (listed, and skipped when
    not asked for); a big-endian header; a compressed block."""
    (tmp_path / "v1").mkdir()
    with tf.Graph().as_default():
        tf.compat.v1.get_variable("w", initializer=tf.constant([1.0, 2.0]))
        saver = tf.compat.v1.train.Saver(write_version=tf.compat.v1.train.SaverDef.V1)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            v1 = saver.save(sess, str(tmp_path / "v1" / "model.ckpt"))
    with pytest.raises(ValueError, match="is a V1 checkpoint"):
        BundleReader(v1)
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        BundleReader(str(tmp_path / "nothing"))

    prefix = str(tmp_path / "odd")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["part", "part", "str", "i8", "ok"],
                      shape_and_slices=["4 2 0,2:-", "4 2 2,2:-", "", "", ""],
                      tensors=[tf.zeros((2, 2)), tf.ones((2, 2)), tf.constant(["x"]),
                               tf.constant([1, 2], tf.int8), tf.constant(3.0)])
    reader = BundleReader(prefix)
    assert reader.get_variable_to_shape_map() == \
        tf.train.load_checkpoint(prefix).get_variable_to_shape_map()
    assert reader.get_tensor("ok") == 3.0
    for name, match in (("part", "partitioned variable"), ("str", "string tensor"),
                        ("i8", "does not map")):
        with pytest.raises(ValueError, match=match):
            reader.get_tensor(name)

    header = bytearray()
    for field, value in ((1, 2), (2, 1)):  # num_shards 2, endianness BIG
        header += bytes([field << 3, value])
    big = str(tmp_path / "big")
    chip_smoke._write_tf_bundle(big, {"x": np.ones(3, np.float32)}, header=bytes(header))
    with pytest.raises(ValueError, match="big-endian"):
        BundleReader(big)

    packed = str(tmp_path / "packed")
    chip_smoke._write_tf_bundle(packed, {"x": np.ones(3, np.float32)})
    index = bytearray(open(packed + ".index", "rb").read())
    size = _data_block_size(index)
    index[size] = 1  # the first block's type byte: snappy
    index[size + 1:size + 5] = struct.pack("<I", t_tfrecord.masked_crc32c(bytes(index[:size + 1])))
    open(packed + ".index", "wb").write(bytes(index))
    with pytest.raises(ValueError, match="is compressed"):
        BundleReader(packed)


def _data_block_size(index):
    (offset, size), _ = tf_bundle._handle(_data_blocks(bytes(index))[0][1], 0)
    assert offset == 0
    return size


def test_chip_smoke_bundle_writer_is_read_by_tf(tf, tmp_path):
    """``chip_smoke._write_tf_bundle`` (the card phase's scaffolding): TF
    reads what it writes, equal to the input and to the port's reader."""
    rng = np.random.default_rng(4)
    values = {f"resnet_model/conv2d_{i}/kernel": rng.standard_normal((3, 3, 2, i + 1))
              .astype(np.float32) for i in range(40)}
    values["global_step"] = np.array(400_000, np.int64)
    values["resnet_model/dense/bias"] = np.zeros(0, np.float32)
    prefix = str(tmp_path / "model.ckpt-400000")
    chip_smoke._write_tf_bundle(prefix, values)
    want = tf.train.load_checkpoint(prefix)
    reader = BundleReader(prefix)
    assert reader.num_shards == chip_smoke.TF_SHARDS
    for name, v in values.items():
        np.testing.assert_array_equal(np.asarray(want.get_tensor(name)), v, err_msg=name)
    _assert_same_as_tf(tf, reader, prefix)
