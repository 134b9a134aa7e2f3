"""Native ``.caffemodel`` reader and converter to the port's state dict.

The port's own copy of ``ideepcolor_tpu/models/caffemodel_io.py``: numpy and
torch, no Caffe. Users of the reference hold ``.caffemodel`` files
(serialized ``NetParameter`` protobufs). This module parses the protobuf wire
format directly (the relevant schema is tiny and stable) and relays the blobs
into :mod:`ideepcolor_tpu_torch.models.caffe_net`'s state dict. Caffe stores
a conv blob as (O, I, kh, kw) and a deconv blob as (I, O, kh, kw), which are
torch's own layouts, so no transpose or flip is needed here (the JAX
converter needs both). The structural '_ss' / '_us' / '_rs' layers are
skipped; the annealed-mean head uses the bin table directly.

Schema subset (field numbers from caffe.proto):
  NetParameter:  layer = 100 (LayerParameter), layers = 2 (V1LayerParameter)
  LayerParameter: name=1 str, type=2 str, blobs=7 BlobProto
  V1LayerParameter: name=4 str, blobs=6 BlobProto
  BlobProto: num=1, channels=2, height=3, width=4 (legacy dims),
             data=5 repeated float (packed or not), shape=7 BlobShape
  BlobShape: dim=1 repeated int64
"""

from __future__ import annotations

import numpy as np
import torch

from .caffe_net import init_state_dict


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _scan(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
            yield field, wt, val
        elif wt == 1:
            yield field, wt, buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:
            yield field, wt, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_blob(buf: bytes) -> np.ndarray:
    dims_legacy = {}
    shape = None
    chunks = []
    for field, wt, val in _scan(buf):
        if field in (1, 2, 3, 4) and wt == 0:
            dims_legacy[field] = val
        elif field == 7 and wt == 2:                 # BlobShape
            dim = []
            for f2, w2, v2 in _scan(val):
                if f2 == 1 and w2 == 0:
                    dim.append(v2)
                elif f2 == 1 and w2 == 2:            # packed varints
                    j = 0
                    while j < len(v2):
                        d, j = _read_varint(v2, j)
                        dim.append(d)
            shape = tuple(dim)
        elif field == 5:
            if wt == 2:                              # packed floats
                chunks.append(np.frombuffer(val, dtype="<f4"))
            elif wt == 5:                            # unpacked float
                chunks.append(np.frombuffer(val, dtype="<f4"))
    data = np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
    if shape is None and dims_legacy:
        shape = tuple(dims_legacy.get(k, 1) for k in (1, 2, 3, 4))
    if shape is not None and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data


def parse_caffemodel(path_or_bytes) -> dict[str, list[np.ndarray]]:
    """Read a .caffemodel -> {layer_name: [blob arrays]}."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    layers: dict[str, list[np.ndarray]] = {}
    for field, wt, val in _scan(buf):
        if wt != 2 or field not in (100, 2):
            continue
        name_field, blob_field = (1, 7) if field == 100 else (4, 6)
        name, blobs = None, []
        for f2, w2, v2 in _scan(val):
            if f2 == name_field and w2 == 2:
                name = v2.decode("utf-8", "replace")
            elif f2 == blob_field and w2 == 2:
                blobs.append(_parse_blob(v2))
        if name and blobs:
            layers[name] = blobs
    return layers


# --- conversion to caffe_net's state dict ---

_SCALE_LAYERS = {"pred_ab", "scale_S", "scale_T"}
_SKIP_SUFFIXES = ("_ss", "_us", "_rs")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def convert_to_params(layers: dict[str, list[np.ndarray]],
                      variant: str = "main") -> dict[str, torch.Tensor]:
    """Map parsed caffemodel blobs into ``CaffeColorNet``'s state dict.

    Conv and deconv blobs keep their layout; BatchNorm's (sum, sumsq,
    count-scale) triplet becomes normalized mean/var (Caffe divides by the
    stored scale factor at TEST time; a stored 0 reads as 1). A layer the
    file lacks keeps the seeded init's value, a layer the variant lacks is
    ignored.
    """
    params = init_state_dict(variant)

    for name, blobs in layers.items():
        if name.endswith(_SKIP_SUFFIXES):
            continue                      # structural: slicing / fixed kernel
        if name in _SCALE_LAYERS:
            key = f"{name}.scale"
            if key in params:
                params[key] = torch.tensor(float(blobs[0].ravel()[0]))
            continue
        if name.endswith("norm"):
            if f"{name}.mean" not in params:
                continue
            scale = float(blobs[2].ravel()[0]) if len(blobs) > 2 else 1.0
            scale = scale if scale != 0 else 1.0
            params[f"{name}.mean"] = _f32(blobs[0].ravel() / scale)
            params[f"{name}.var"] = _f32(blobs[1].ravel() / scale)
            continue
        wkey = f"{name}.weight"
        if wkey not in params:
            # 'bw_conv1_1' appears as top 'conv1_1' in the global prototxt
            continue
        params[wkey] = _f32(blobs[0].reshape(params[wkey].shape))
        if len(blobs) > 1:
            params[f"{name}.bias"] = _f32(blobs[1].ravel())
    return params


def load_caffemodel(path: str, variant: str = "main"
                    ) -> dict[str, torch.Tensor]:
    return convert_to_params(parse_caffemodel(path), variant)


def layers_from_state_dict(sd) -> dict[str, list[np.ndarray]]:
    """The inverse of :func:`convert_to_params`: a ``CaffeColorNet`` state
    dict -> the blobs of its ``.caffemodel`` layers (a conv's weight and
    bias; a BatchNorm's mean, variance and a stored scale of 1; a scale
    layer's one value), for :func:`encode_caffemodel`."""
    slots = {"weight": 0, "bias": 1, "mean": 0, "var": 1, "scale": 0}
    blobs: dict[str, dict[int, np.ndarray]] = {}
    for key, value in sd.items():
        name, field = key.rsplit(".", 1)
        blobs.setdefault(name, {})[slots[field]] = \
            value.detach().cpu().numpy().reshape(value.shape or (1,))
    layers = {name: [b[i] for i in sorted(b)] for name, b in blobs.items()}
    for name, layer in layers.items():
        if name.endswith("norm"):
            layer.append(np.ones(1, np.float32))
    return layers


# --- tiny encoder (tests + fixture generation) ---

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_blob(arr: np.ndarray) -> bytes:
    shape_msg = b"".join(_tag(1, 0) + _varint(d) for d in arr.shape)
    data = np.asarray(arr, "<f4").ravel().tobytes()
    return _len_field(7, shape_msg) + _len_field(5, data)


def encode_caffemodel(layers: dict[str, list[np.ndarray]]) -> bytes:
    """Serialize {name: blobs} as a NetParameter (LayerParameter form)."""
    out = b""
    for name, blobs in layers.items():
        layer = _len_field(1, name.encode())
        layer += _len_field(2, b"Convolution")
        for b in blobs:
            layer += _len_field(7, encode_blob(b))
        out += _len_field(100, layer)
    return out


def encode_blob_legacy(arr: np.ndarray) -> bytes:
    """BlobProto in the pre-BlobShape form old Caffe snapshots use:
    num/channels/height/width varints (fields 1-4) + packed float data."""
    a = np.asarray(arr)
    dims = (1,) * (4 - a.ndim) + a.shape
    msg = b"".join(_tag(f, 0) + _varint(d)
                   for f, d in zip((1, 2, 3, 4), dims))
    return msg + _len_field(5, np.asarray(a, "<f4").ravel().tobytes())


# V1LayerParameter.LayerType enum values (caffe.proto) for the layer
# types that appear in the reference graphs; V1 predates BatchNorm/Scale
# (those snapshots would carry custom types), so unknown ones encode as 0.
_V1_TYPES = {"Convolution": 4, "Deconvolution": 39, "ReLU": 18,
             "Eltwise": 25, "Slice": 33, "Softmax": 20, "TanH": 23,
             "Input": 0, "BatchNorm": 0, "Scale": 0}


def encode_netparameter(layer_specs, net_name: str = "", v1: bool = False
                        ) -> bytes:
    """Serialize layers the way a real Caffe snapshot does.

    layer_specs: ordered list of dicts with keys
      name (str), type (str), blobs (list of arrays; may be empty for
      ReLU/Eltwise/... layers), bottom/top (optional lists of str),
      lr_mults (optional list of float, emitted as ParamSpec messages).

    v1=False -> modern NetParameter.layer (field 100, LayerParameter:
    name=1 type=2 bottom=3 top=4 param=6 blobs=7) with BlobShape'd blobs;
    v1=True -> legacy NetParameter.layers (field 2, V1LayerParameter:
    bottom=2 top=3 name=4 type=5(enum) blobs=6) with num/channels/height/
    width legacy blob dims. Layers without blobs are emitted too — real
    snapshots serialize the whole graph, and readers must skip them.
    """
    out = b""
    if net_name:
        out += _len_field(1, net_name.encode())
    for spec in layer_specs:
        name = spec["name"].encode()
        btm = [s.encode() for s in spec.get("bottom", ())]
        top = [s.encode() for s in spec.get("top", ())]
        blobs = spec.get("blobs", ())
        if v1:
            layer = b"".join(_len_field(2, s) for s in btm)
            layer += b"".join(_len_field(3, s) for s in top)
            layer += _len_field(4, name)
            layer += _tag(5, 0) + _varint(_V1_TYPES.get(spec["type"], 0))
            layer += b"".join(_len_field(6, encode_blob_legacy(b))
                              for b in blobs)
            out += _len_field(2, layer)
        else:
            layer = _len_field(1, name)
            layer += _len_field(2, spec["type"].encode())
            layer += b"".join(_len_field(3, s) for s in btm)
            layer += b"".join(_len_field(4, s) for s in top)
            for lr in spec.get("lr_mults", ()):
                # ParamSpec { lr_mult = 3 (float) } — readers must skip
                pspec = _tag(3, 5) + np.float32(lr).tobytes()
                layer += _len_field(6, pspec)
            layer += b"".join(_len_field(7, encode_blob(b)) for b in blobs)
            out += _len_field(100, layer)
    return out
