"""The port's DataHandler (convnet_tpu_torch.data.datahandler) against the
JAX package's, on the CPU: the same config and seed give array-equal
batches, with and without the prefetch thread, with a chunked shuffle and
with a randomize_gpu window."""

import numpy as np
import pytest

from convnet_tpu import config
from convnet_tpu.data.datahandler import DataHandler as JaxDataHandler
from convnet_tpu_torch import config as pt_config
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.data.jitter import JitterSpec

DATA = """
name: "d"
batch_size: {batch}
randomize_cpu: {randomize}
randomize_gpu: {window}
chunk_size: {chunk}
random_access_chunk_size: 5
pipeline_loads: {pipeline}
data_config {{ layer_name: "input" data_type: DUMMY raw_image_size: 10 image_size: 8
              can_translate: true can_flip: true scale: 0.0039215686 dummy_size: 100 }}
data_config {{ layer_name: "labels" data_type: DUMMY dummy_size: 100 dummy_num_classes: 7 }}
"""


def _cfgs(text):
    """(JAX config, port config): one data pbtxt through each package's
    own reader (their proto classes are distinct types)."""
    return config.parse_dataset_config(text), pt_config.parse_dataset_config(text)


def _cfg(pipeline=True, randomize=True, window=False, chunk=0, batch=16):
    text = DATA.format(
        pipeline=str(pipeline).lower(), randomize=str(randomize).lower(),
        window=str(window).lower(), chunk=chunk, batch=batch,
    )
    return _cfgs(text)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("randomize,window,chunk", [(True, False, 0), (False, False, 0),
                                                    (True, True, 0), (False, True, 40)])
def test_batches_array_equal_to_jax(pipeline, randomize, window, chunk):
    jcfg, cfg = _cfg(pipeline, randomize, window, chunk)
    ours, ref = DataHandler(cfg, seed=3), JaxDataHandler(jcfg, seed=3)
    try:
        assert ours.num_rows == ref.num_rows == 100 and ours.num_batches == 6
        for _ in range(15):  # past two epochs: reshuffles and window refills
            a, b = ours.get_batch(), ref.get_batch()
            assert set(a) == set(b) == {"input", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.get_batch()["input"].shape == (16, 10, 10, 3)
    finally:
        ours.close()
        ref.close()


def test_iter_epoch_reset_and_metadata():
    jcfg, cfg = _cfg(pipeline=True)
    ours, ref = DataHandler(cfg), JaxDataHandler(jcfg)
    try:
        got = list(ours.iter_epoch())
        want = list(ref.iter_epoch())
        assert [v for _, v in got] == [v for _, v in want] == [16] * 6 + [4]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a["input"], b["input"])
        assert len(list(ours.iter_epoch(include_partial=False))) == 6
        for h in (ours, ref):
            h.get_batch()
            h.reset()
        np.testing.assert_array_equal(ours.get_batch()["labels"], ref.get_batch()["labels"])
        assert ours.input_image_sizes() == ref.input_image_sizes() == {"input": 8}
        (spec, mean, std), = ours.jitter_specs().values()
        assert isinstance(spec, JitterSpec) and mean is None and std is None
        jspec = ref.jitter_specs()["input"][0]
        assert (spec.image_size, spec.can_translate, spec.can_flip, spec.scale) == (
            jspec.image_size, jspec.can_translate, jspec.can_flip, jspec.scale)
    finally:
        ours.close()
        ref.close()
    ours.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        ours.reset()


def test_unknown_stream_type_raises():
    """Every data type of the schema has a stream; a value outside the
    enum raises ValueError, and so does a config with no streams."""
    from types import SimpleNamespace

    from convnet_tpu_torch import proto as pt_pb
    from convnet_tpu_torch.data.datahandler import make_stream

    kinds = pt_pb.DataStreamConfig.DataType
    assert set(kinds.keys()) == {"DUMMY", "HDF5", "IMAGE_RAW", "SLIDING_WINDOW", "TXT", "RAW_CACHE"}
    with pytest.raises(ValueError, match="unknown data_type 99"):
        make_stream(SimpleNamespace(data_type=99, layer_name="input"))
    with pytest.raises(ValueError, match="no data_config"):
        DataHandler(pt_config.parse_dataset_config('name: "empty"'))


def test_prefetch_error_reaches_get_batch():
    _, cfg = _cfg(pipeline=True)
    h = DataHandler(cfg)
    try:
        h.get_batch()

        def broken(idx):
            raise OSError("disk gone")

        h.streams["input"].read_rows = broken
        with pytest.raises(RuntimeError, match="prefetch failed"):
            for _ in range(10):
                h.get_batch()
    finally:
        h.close()


def test_hdf5_stream_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "d.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f["input"] = rng.integers(0, 256, (40, 8 * 8 * 3), dtype=np.uint8)  # flat rows
        f["labels"] = rng.integers(0, 5, 40).astype(np.int32)
    jcfg, cfg = _cfgs(f"""
        name: "h" batch_size: 8 randomize_cpu: true pipeline_loads: false
        data_config {{ layer_name: "input" data_type: HDF5 file_pattern: "{path}" image_size: 8 }}
        data_config {{ layer_name: "labels" data_type: HDF5 file_pattern: "{path}" }}
    """)
    ours, ref = DataHandler(cfg), JaxDataHandler(jcfg)
    try:
        for _ in range(7):
            a, b = ours.get_batch(), ref.get_batch()
            assert a["input"].shape == (8, 8, 8, 3)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        (last, valid), = list(ours.iter_epoch())[-1:]
        assert valid == 8 and last["labels"].shape == (8,)
    finally:
        ours.close()
        ref.close()
