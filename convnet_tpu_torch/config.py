"""Protobuf-text (.pbtxt) configuration loading: the port's copy of
`convnet_tpu/config.py`, over the port's own schema
(`convnet_tpu_torch.proto`).

Reference counterpart: `ReadPbtxt*` helpers in src/util.cc [U] — the
reference parses model / optimizer / data configs from protobuf text
files; this module does the same via google.protobuf.text_format so the
reference's model files parse unchanged.
"""

from __future__ import annotations

import os

from google.protobuf import text_format

from convnet_tpu_torch import proto as pb

# Flipped by the CLIs' --strict flag (or CONVNET_STRICT_PBTXT=1):
# unknown fields become hard errors instead of warnings, so schema
# drift vs real upstream configs is loud (VERDICT.md round-1 #3).
STRICT = os.environ.get("CONVNET_STRICT_PBTXT", "") == "1"


def set_strict(value: bool) -> None:
    global STRICT
    STRICT = bool(value)


def _parse(text: str, message, lenient: bool):
    """Parse pbtxt. Strict first; when `lenient`, retry accepting unknown
    fields (schema recovered without the reference mount — SURVEY.md
    provenance note — so real upstream configs may carry fields this
    schema doesn't model yet; warn, don't fail)."""
    try:
        return text_format.Parse(text, message)
    except text_format.ParseError as e:
        if not lenient:
            raise
        import sys

        message.Clear()
        out = text_format.Parse(text, message, allow_unknown_field=True)
        print(
            f"warning: pbtxt has fields unknown to this schema ({e}); "
            "parsed leniently — check convnet_tpu_torch/proto/__init__.py",
            file=sys.stderr,
        )
        return out


def _read_pbtxt(path: str, message, lenient: bool = True):
    if not os.path.exists(path):
        raise FileNotFoundError(f"pbtxt not found: {path}")
    with open(path, "r") as f:
        return _parse(f.read(), message, lenient and not STRICT)


def parse_model(text: str) -> pb.Model:
    """Parse a model pbtxt string into a config.Model proto."""
    return text_format.Parse(text, pb.Model())


def read_model(path: str) -> pb.Model:
    """Load a model .pbtxt (reference: ReadModel / ReadPbtxt<Model> [U])."""
    return _read_pbtxt(path, pb.Model())


def read_dataset_config(path: str) -> pb.DatasetConfig:
    """Load a data .pbtxt (reference: ReadDataConfig [U])."""
    return _read_pbtxt(path, pb.DatasetConfig())


def parse_dataset_config(text: str) -> pb.DatasetConfig:
    return text_format.Parse(text, pb.DatasetConfig())


def read_feature_extractor_config(path: str) -> pb.FeatureExtractorConfig:
    return _read_pbtxt(path, pb.FeatureExtractorConfig())


def model_to_text(model: pb.Model) -> str:
    return text_format.MessageToString(model)
