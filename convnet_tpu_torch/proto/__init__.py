"""The port's own copy of the `.pbtxt` schema (`config` package of
`convnet_config.proto`): the message classes the config reader and the
graph IR build from.

The bytes below are the serialized `FileDescriptorProto` that protoc
wrote into `convnet_tpu/proto/convnet_config_pb2.py`, so both packages
read the same `.pbtxt` files alike. They are loaded into a private
`DescriptorPool`, not protobuf's default pool: the JAX package registers
`convnet_config.proto` in the default pool, and a second registration of
the same file name there raises "duplicate file name" in any process that
imports both packages (the parity tests do). The price is that the two
packages' message classes are distinct types: a message parsed by one
package's reader is not handed to the other package's functions.

The port's schema is those bytes plus its own additions (`ADDITIONS`),
applied here, in one place, to a parsed copy of them before the copy is
loaded: the edge types `CONCAT` (a layer joined by concatenating its
sources along the channels) and `AVGPOOL` (an average pool with kernel,
stride and padding), and the field `Layer.loss_weight` (an output layer's
weight in the summed loss, default 1). Their numbers are ones the JAX
package's schema does not use, so a file that holds none of them reads
alike in both packages.
"""

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

SERIALIZED = (
    b'\n\x14convnet_config.proto\x12\x06config"\xbf\x03\n\x05Model\x12\x0c\n\x04name'
    b'\x18\x01 \x02(\t\x12\x1c\n\x05layer\x18\x02 \x03(\x0b2\r.config.Layer\x12\x1a\n\x04edge\x18\x03 \x03'
    b'(\x0b2\x0c.config.Edge\x12\x10\n\x04seed\x18\x04 \x01(\x05:\x0242\x12\x16\n\x08max_iter\x18\x05'
    b' \x01(\x05:\x041000\x12\x17\n\nbatch_size\x18\x06 \x01(\x05:\x03128\x12\x1a\n\rdisplay_a'
    b'fter\x18\x07 \x01(\x05:\x03100\x12\x19\n\x0evalidate_after\x18\x08 \x01(\x05:\x010\x12\x1b\n\x10va'
    b'lidate_batches\x18\t \x01(\x05:\x010\x12\x1b\n\x10checkpoint_after\x18\n \x01('
    b'\x05:\x010\x12\x16\n\x0echeckpoint_dir\x18\x0b \x01(\t\x12\x11\n\ttimestamp\x18\x0c \x01(\t\x12'
    b'\x19\n\x11timestamp_history\x18\r \x03(\t\x12\x1e\n\rcompute_dtype\x18d \x01('
    b'\t:\x07float32\x12"\n\x08parallel\x18e \x01(\x0b2\x10.config.Parallel\x12\x14'
    b'\n\x05remat\x18f \x01(\x08:\x05false\x12\x1a\n\x10activation_dtype\x18g \x01(\t:\x00'
    b'"-\n\x08Parallel\x12\x0f\n\x04data\x18\x01 \x01(\x05:\x011\x12\x10\n\x05model\x18\x02 \x01(\x05:\x011"'
    b'\xde\x03\n\x05Layer\x12\x0c\n\x04name\x18\x01 \x02(\t\x12\x17\n\x0cnum_channels\x18\x02 \x01(\x05:\x011'
    b'\x124\n\nactivation\x18\x03 \x01(\x0e2\x18.config.Layer.Activation:\x06'
    b'LINEAR\x12\x17\n\x08is_input\x18\x04 \x01(\x08:\x05false\x12\x18\n\tis_output\x18\x05 \x01'
    b'(\x08:\x05false\x12\x13\n\x08dropprob\x18\x06 \x01(\x02:\x010\x127\n\rloss_function\x18'
    b'\x07 \x01(\x0e2\x1a.config.Layer.LossFunction:\x04NONE\x12\x12\n\ndata_'
    b'field\x18\x08 \x01(\t\x12\x11\n\x06gpu_id\x18\t \x01(\x05:\x010\x12\x15\n\nimage_size\x18\n \x01'
    b'(\x05:\x010"S\n\nActivation\x12\n\n\x06LINEAR\x10\x00\x12\x0c\n\x08LOGISTIC\x10\x01\x12\x14\n'
    b'\x10RECTIFIED_LINEAR\x10\x02\x12\x0b\n\x07SOFTMAX\x10\x03\x12\x08\n\x04TANH\x10\x04"d\n\x0cLo'
    b'ssFunction\x12\x08\n\x04NONE\x10\x00\x12\x11\n\rSQUARED_ERROR\x10\x01\x12\x1d\n\x19CROSS'
    b'_ENTROPY_MULTINOMIAL\x10\x02\x12\x18\n\x14CROSS_ENTROPY_BINARY\x10\x03'
    b'"\xbc\x07\n\x04Edge\x12\x0e\n\x06source\x18\x01 \x02(\t\x12\x0c\n\x04dest\x18\x02 \x02(\t\x12(\n\tedge_'
    b'type\x18\x03 \x02(\x0e2\x15.config.Edge.EdgeType\x12\x16\n\x0bkernel_size'
    b'\x18\x04 \x01(\x05:\x010\x12\x11\n\x06stride\x18\x05 \x01(\x05:\x011\x12\x12\n\x07padding\x18\x06 \x01(\x05:\x010'
    b'\x12C\n\x0einitialization\x18\x07 \x01(\x0e2\x1b.config.Edge.Initializ'
    b'ation:\x0eDENSE_GAUSSIAN\x12\x1e\n\x07init_wt\x18\x08 \x01(\x02:\r0.009999'
    b'99978\x12\x14\n\tinit_bias\x18\t \x01(\x02:\x010\x12+\n\x10weight_optimizer\x18'
    b'\n \x01(\x0b2\x11.config.Optimizer\x12)\n\x0ebias_optimizer\x18\x0b \x01(\x0b'
    b'2\x11.config.Optimizer\x12\x14\n\tadd_scale\x18\x0c \x01(\x02:\x010\x12\x17\n\tpow'
    b'_scale\x18\r \x01(\x02:\x040.75\x12+\n\x1dfrac_of_filters_response_n'
    b'orm\x18\x0e \x01(\x02:\x040.25\x12$\n\x15response_norm_blocked\x18\x0f \x01(\x08:\x05'
    b'false\x12\x18\n\rsample_factor\x18\x10 \x01(\x05:\x011\x12\x19\n\x0bshared_bias\x18\x11'
    b' \x01(\x08:\x04true\x12\x18\n\x10pretrained_model\x18\x12 \x01(\t\x12\x1c\n\x14pretrain'
    b'ed_edge_name\x18\x13 \x01(\t\x12\x11\n\x06gpu_id\x18\x14 \x01(\x05:\x010\x12\x0c\n\x04name\x18\x15 '
    b'\x01(\t\x12\x15\n\nnum_groups\x18d \x01(\x05:\x011"\x86\x01\n\x08EdgeType\x12\x06\n\x02FC\x10\x00\x12'
    b'\x08\n\x04CONV\x10\x01\x12\x0b\n\x07MAXPOOL\x10\x02\x12\x11\n\rRESPONSE_NORM\x10\x03\x12\t\n\x05LOC'
    b'AL\x10\x04\x12\x0c\n\x08UPSAMPLE\x10\x05\x12\x0e\n\nDOWNSAMPLE\x10\x06\x12\x0c\n\x08RGBTOYUV\x10\x07'
    b'\x12\x11\n\rCONV_ONETOONE\x10\x08"\xa9\x01\n\x0eInitialization\x12\x0c\n\x08CONSTA'
    b'NT\x10\x00\x12\x12\n\x0eDENSE_GAUSSIAN\x10\x01\x12\x13\n\x0fSPARSE_GAUSSIAN\x10\x02\x12\x1e\n'
    b'\x1aDENSE_GAUSSIAN_SQRT_FAN_IN\x10\x03\x12\x11\n\rDENSE_UNIFORM\x10\x04'
    b'\x12\x1d\n\x19DENSE_UNIFORM_SQRT_FAN_IN\x10\x05\x12\x0e\n\nPRETRAINED\x10\x06"'
    b'\xa5\x04\n\tOptimizer\x12T\n\x0eoptimizer_type\x18\x01 \x01(\x0e2\x1f.config.O'
    b'ptimizer.OptimizerType:\x1bSTOCHASTIC_GRADIENT_DESC'
    b'ENT\x12#\n\x0cbase_epsilon\x18\x02 \x01(\x02:\r0.00999999978\x124\n\repsi'
    b'lon_decay\x18\x03 \x01(\x0e2\x17.config.Optimizer.Decay:\x04NONE\x12"'
    b'\n\x17epsilon_decay_timescale\x18\x04 \x01(\x05:\x011\x12\x1b\n\x10initial_mo'
    b'mentum\x18\x05 \x01(\x02:\x010\x12\x19\n\x0efinal_momentum\x18\x06 \x01(\x02:\x010\x12(\n\x1dmo'
    b'mentum_transition_timescale\x18\x07 \x01(\x05:\x011\x12\x13\n\x08l2_decay'
    b'\x18\x08 \x01(\x02:\x010\x12\x1c\n\x11weight_norm_limit\x18\t \x01(\x02:\x010\x12\x18\n\rgradi'
    b'ent_clip\x18\n \x01(\x02:\x010\x12#\n\x18start_optimization_after\x18\x0b '
    b'\x01(\x05:\x010"0\n\rOptimizerType\x12\x1f\n\x1bSTOCHASTIC_GRADIENT_D'
    b'ESCENT\x10\x00"=\n\x05Decay\x12\x08\n\x04NONE\x10\x00\x12\r\n\tINVERSE_T\x10\x01\x12\x0f\n\x0bEX'
    b'PONENTIAL\x10\x02\x12\n\n\x06LINEAR\x10\x03"\xb3\x02\n\rDatasetConfig\x12\x0c\n\x04nam'
    b'e\x18\x01 \x01(\t\x12-\n\x0bdata_config\x18\x02 \x03(\x0b2\x18.config.DataStream'
    b'Config\x12\x17\n\nbatch_size\x18\x03 \x01(\x05:\x03128\x12\x15\n\nchunk_size\x18\x04 '
    b'\x01(\x05:\x010\x12\x1b\n\x10max_dataset_size\x18\x05 \x01(\x05:\x010\x12\x1c\n\rrandomize'
    b'_cpu\x18\x06 \x01(\x08:\x05false\x12\x1c\n\rrandomize_gpu\x18\x07 \x01(\x08:\x05false\x12'
    b'\x1c\n\x0epipeline_loads\x18\x08 \x01(\x08:\x04true\x12#\n\x18random_access_c'
    b'hunk_size\x18\t \x01(\x05:\x011\x12\x19\n\x0eprefetch_depth\x18d \x01(\x05:\x012"\xfc\x03'
    b'\n\x10DataStreamConfig\x12\x12\n\nlayer_name\x18\x01 \x02(\t\x12:\n\tdata_t'
    b'ype\x18\x02 \x01(\x0e2!.config.DataStreamConfig.DataType:\x04HD'
    b'F5\x12\x14\n\x0cfile_pattern\x18\x03 \x01(\t\x12\x14\n\x0cdataset_name\x18\x04 \x01(\t\x12\x15'
    b'\n\nimage_size\x18\x05 \x01(\x05:\x010\x12\x19\n\x0eraw_image_size\x18\x06 \x01(\x05:\x010'
    b'\x12\x15\n\nnum_colors\x18\x07 \x01(\x05:\x013\x12\x1c\n\rcan_translate\x18\x08 \x01(\x08:\x05'
    b'false\x12\x17\n\x08can_flip\x18\t \x01(\x08:\x05false\x12\x11\n\tmean_file\x18\n \x01('
    b'\t\x12\x18\n\tnormalize\x18\x0b \x01(\x08:\x05false\x12\x10\n\x05scale\x18\x0c \x01(\x02:\x011\x12\x18\n'
    b'\rwindow_stride\x18\r \x01(\x05:\x011\x12\x18\n\ndummy_size\x18\x0e \x01(\x05:\x04102'
    b'4\x12\x1d\n\x11dummy_num_classes\x18\x0f \x01(\x05:\x0210"Z\n\x08DataType\x12\t\n\x05'
    b'DUMMY\x10\x00\x12\x08\n\x04HDF5\x10\x01\x12\r\n\tIMAGE_RAW\x10\x02\x12\x12\n\x0eSLIDING_WIND'
    b'OW\x10\x03\x12\x07\n\x03TXT\x10\x04\x12\r\n\tRAW_CACHE\x10\x05"i\n\x16FeatureExtractor'
    b'Config\x12\x12\n\ninput_file\x18\x01 \x01(\t\x12\x13\n\x0boutput_file\x18\x02 \x01(\t\x12'
    b'\r\n\x05layer\x18\x03 \x03(\t\x12\x17\n\nbatch_size\x18\x04 \x01(\x05:\x03128'
)

#: The port's additions to the JAX package's schema: (message, enum,
#: value name, number) for enum values, (message, field name, number,
#: default) for optional float fields.
ADDITIONS = {
    "enum_values": (("Edge", "EdgeType", "CONCAT", 200), ("Edge", "EdgeType", "AVGPOOL", 201)),
    "float_fields": (("Layer", "loss_weight", 200, "1"),),
}


def _with_additions(base: bytes) -> bytes:
    """The serialized schema `base` with ADDITIONS applied."""
    fd = descriptor_pb2.FileDescriptorProto.FromString(base)
    msgs = {m.name: m for m in fd.message_type}
    for msg, enum, name, number in ADDITIONS["enum_values"]:
        (e,) = [e for e in msgs[msg].enum_type if e.name == enum]
        e.value.add(name=name, number=number)
    for msg, name, number, default in ADDITIONS["float_fields"]:
        msgs[msg].field.add(name=name, number=number, default_value=default,
                            label=descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL,
                            type=descriptor_pb2.FieldDescriptorProto.TYPE_FLOAT)
    return fd.SerializeToString()


_POOL = descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(_with_additions(SERIALIZED))


def _message(name: str):
    return message_factory.GetMessageClass(_POOL.FindMessageTypeByName(f"config.{name}"))


Model = _message("Model")
Parallel = _message("Parallel")
Layer = _message("Layer")
Edge = _message("Edge")
Optimizer = _message("Optimizer")
DatasetConfig = _message("DatasetConfig")
DataStreamConfig = _message("DataStreamConfig")
FeatureExtractorConfig = _message("FeatureExtractorConfig")
