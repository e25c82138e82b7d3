"""ONNX emission without the ``onnx`` package — counterpart of
``yolojax/tools/onnx_export.py``.

The port does not depend on ``onnx`` or ``onnxruntime``, so this module
serializes the ONNX protobuf wire format directly: a ~60-line
protobuf encoder plus a graph builder that walks the model *plan*
(models/engine.py) and emits the folded inference graph — Conv(+bias)
+LeakyRelu blocks, MaxPool, the passthrough reorg as Reshape/Transpose
chains, Concat, and the full YOLOv2 decode (sigmoid/exp/softmax/grid
offsets) to one packed ``(B, N, 5+C)`` ``[ymin, xmin, ymax, xmax, iou,
conf...]`` output — the same contract as the ``torch.export`` program
(cli/export.py) and ops/decode.py::decode_flat.

The writer and :func:`check_model` are the reference's, line for line.  The
one difference is the weights: the port's folded conv weights are OIHW
already (in the model's compute dtype), so they are cast to f32 and written
as they are, where the reference transposes its HWIO arrays.  For the same
f32 weights the ModelProto's graph (field 7) is the reference's byte for
byte (tests/test_torch_export.py).

Field numbers follow onnx/onnx.proto (IR version 6, default opset 11 —
the ONNX 1.6 level, chosen for broad runtime compatibility).  Convention:
NCHW input ``images`` (B, 3, S, S), float32 in [0, 1].
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["export_onnx", "check_model"]

# ---------------------------------------------------------------- protobuf --

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, _VARINT) + _varint(int(v))


def _f_bytes(field: int, b: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(b)) + b


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, _I32) + struct.pack("<f", v)


def _f_packed_varints(field: int, vals) -> bytes:
    body = b"".join(_varint(int(v)) for v in vals)
    return _f_bytes(field, body)


# ------------------------------------------------------------ ONNX objects --

_DT_FLOAT, _DT_INT64 = 1, 7
# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR, _AT_FLOATS, _AT_INTS = 1, 2, 3, 4, 6, 7


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int64:
        dt = _DT_INT64
    else:
        arr = arr.astype(np.float32)
        dt = _DT_FLOAT
    return (_f_packed_varints(1, arr.shape)
            + _f_varint(2, dt)
            + _f_str(8, name)
            + _f_bytes(9, arr.tobytes()))


def _attr(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = _f_str(1, name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _f_varint(3, int(value)) + _f_varint(20, _AT_INT)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, _AT_FLOAT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_varint(20, _AT_STRING)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, np.integer)) for v in value):
        out += _f_packed_varints(8, value) + _f_varint(20, _AT_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_tag(7, _I32) + struct.pack("<f", float(v)) for v in value)
        out += _f_varint(20, _AT_FLOATS)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, _tensor(name + "_value", value)) + _f_varint(20, _AT_TENSOR)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_f_str(1, i) for i in inputs)
    out += b"".join(_f_str(2, o) for o in outputs)
    out += _f_str(3, name or outputs[0]) + _f_str(4, op_type)
    out += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, shape, elem_type: int = _DT_FLOAT) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto.tensor_type=1;
    Tensor{elem_type=1, shape=2}; TensorShapeProto.dim=1; Dimension.dim_value=1."""
    dims = b"".join(_f_bytes(1, _f_varint(1, d)) for d in shape)
    tensor_type = _f_varint(1, elem_type) + _f_bytes(2, dims)
    return _f_str(1, name) + _f_bytes(2, _f_bytes(1, tensor_type))


class _Graph:
    """Accumulates nodes + initializers; hands out unique tensor names."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self.inits.append(_tensor(name, arr))
        return name

    def add(self, op_type: str, inputs, hint: str | None = None, **attrs) -> str:
        out = self.fresh(hint or op_type.lower())
        self.nodes.append(_node(op_type, inputs, [out], **attrs))
        return out

    def reshape(self, x: str, shape) -> str:
        s = self.init_tensor("shape", np.asarray(shape, np.int64))
        return self.add("Reshape", [x, s])

    def const(self, hint: str, arr) -> str:
        return self.init_tensor(hint, np.asarray(arr, np.float32))


def _emit_reorg(g: _Graph, x: str, c: int, h: int, w: int, stride: int,
                order: str) -> str:
    """Passthrough reorg on an NCHW tensor as Reshape→Transpose→Reshape
    (both channel-order variants, ops/reorg.py semantics)."""
    s = stride
    if order == "darknet":
        # view (C/s², H·s, W·s), offset-major s2d, reinterpret (C·s², H/s, W/s)
        t = g.reshape(x, [0, c // (s * s), h, s, w, s])
    elif order == "s2d":
        t = g.reshape(x, [0, c, h // s, s, w // s, s])
    else:
        raise ValueError(f"unknown reorg order {order!r}")
    t = g.add("Transpose", [t], perm=[0, 3, 5, 1, 2, 4])
    return g.reshape(t, [0, c * s * s, h // s, w // s])


def _emit_decode(g: _Graph, raw: str, anchors: np.ndarray, num_classes: int,
                 gh: int, gw: int, batch: int) -> str:
    """YOLOv2 decode (ops/decode.py semantics) → packed (B, N, 5+C)."""
    a = anchors.shape[0]
    c = num_classes
    per = 5 + c
    # NCHW (B, A*per, gh, gw) → (B, gh, gw, A, per)
    x = g.add("Transpose", [raw], perm=[0, 2, 3, 1])
    x = g.reshape(x, [0, gh, gw, a, per])

    i64 = lambda v: g.init_tensor("idx", np.asarray(v, np.int64))
    ax4 = i64([4])

    def slc(lo, hi):
        return g.add("Slice", [x, i64([lo]), i64([hi]), ax4])

    t_yx, t_hw, t_o, t_cls = slc(0, 2), slc(2, 4), slc(4, 5), slc(5, per)

    oy, ox = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    offset = np.stack([oy, ox], -1).astype(np.float32)[None, :, :, None, :]
    scale = g.const("grid_scale", np.asarray([gh, gw], np.float32))

    sig_yx = g.add("Sigmoid", [t_yx])
    center = g.add("Add", [sig_yx, g.const("grid_offset", offset)])
    center = g.add("Div", [center, scale])

    clipped = g.add("Clip", [t_hw, g.const("clip_lo", np.float32(-12.0)),
                             g.const("clip_hi", np.float32(12.0))])
    size = g.add("Exp", [clipped])
    size = g.add("Mul", [size, g.const(
        "anchors", anchors.astype(np.float32).reshape(1, 1, 1, a, 2))])
    size = g.add("Div", [size, scale])
    half = g.add("Mul", [size, g.const("half", np.float32(0.5))])
    yx_min = g.add("Sub", [center, half])
    yx_max = g.add("Add", [center, half])

    iou = g.add("Sigmoid", [t_o])
    prob = g.add("Softmax", [t_cls], axis=4)
    conf = g.add("Mul", [iou, prob])

    packed = g.add("Concat", [yx_min, yx_max, iou, conf], axis=4)
    return g.reshape(packed, [batch, gh * gw * a, per])


def _f32(t) -> np.ndarray:
    """A tensor (any device, any float dtype) as an f32 numpy array."""
    return t.detach().to("cpu", torch.float32).numpy()


def export_onnx(model, folded, anchors, size: int, batch: int = 1,
                opset: int = 11, include_decode: bool = True) -> bytes:
    """Serialize the folded inference graph as an ONNX ModelProto.

    model: a plan model (models/darknet.py, models/mobilenet.py);
    folded: ``model.fold(params, state)`` output ({name: {w, b, ...}} of
    tensors, ``w`` OIHW).
    Input tensor ``images``: float32 NCHW (batch, 3, size, size) in [0, 1];
    output ``detections``: (batch, N, 5+C) packed decode (decode_flat).
    """
    g = _Graph()
    x = "images"
    h = w = size
    ch = 3
    slots: dict[str, tuple[str, int, int, int]] = {}
    for op in model.plan:
        kind = op[0]
        if kind == "conv":
            d = op[1]
            oihw = _f32(folded[d.name]["w"])                    # OIHW
            bias = _f32(folded[d.name]["b"])
            pad = d.ksize // 2
            x = g.add("Conv", [x, g.init_tensor(d.name + "_w", oihw),
                               g.init_tensor(d.name + "_b", bias)],
                      hint=d.name, kernel_shape=[d.ksize, d.ksize],
                      strides=[d.stride, d.stride],
                      pads=[pad, pad, pad, pad], group=d.groups)
            h, w = (h + 2 * pad - d.ksize) // d.stride + 1, \
                   (w + 2 * pad - d.ksize) // d.stride + 1
            ch = d.out_ch
            if d.act:
                x = g.add("LeakyRelu", [x], hint=d.name + "_act", alpha=0.1)
        elif kind == "pool":
            k, s = op[1], op[2]
            # darknet: VALID for stride 2, SAME (pad bottom/right) for the
            # Tiny stride-1 tail pool (models/blocks.py::max_pool)
            pads = [0, 0, 0, 0] if s != 1 else [0, 0, k - 1, k - 1]
            x = g.add("MaxPool", [x], kernel_shape=[k, k], strides=[s, s],
                      pads=pads)
            h = (h + pads[0] + pads[2] - k) // s + 1
            w = (w + pads[1] + pads[3] - k) // s + 1
        elif kind == "mark":
            slots[op[1]] = (x, ch, h, w)
        elif kind == "load":
            x, ch, h, w = slots[op[1]]
        elif kind == "reorg":
            x = _emit_reorg(g, x, ch, h, w, op[1], model.reorg_order)
            ch *= op[1] * op[1]
            h //= op[1]
            w //= op[1]
        elif kind == "concat":
            x = g.add("Concat", [x, slots[op[1]][0]], axis=1)
            ch += slots[op[1]][1]
        else:
            raise ValueError(f"unknown plan op {kind!r}")

    n_out = model.out_channels
    if include_decode:
        out = _emit_decode(g, x, np.asarray(anchors, np.float32),
                           model.num_classes, h, w, batch)
        out_shape = [batch, h * w * len(anchors), 5 + model.num_classes]
    else:
        out = x
        out_shape = [batch, n_out, h, w]
    g.nodes.append(_node("Identity", [out], ["detections"]))

    # GraphProto: node=1, name=2, initializer=5, input=11, output=12
    graph = b"".join(_f_bytes(1, n) for n in g.nodes)
    graph += _f_str(2, type(model).__name__.lower())
    graph += b"".join(_f_bytes(5, t) for t in g.inits)
    graph += _f_bytes(11, _value_info("images", (batch, 3, size, size)))
    graph += _f_bytes(12, _value_info("detections", out_shape))

    # ModelProto: ir_version=1, producer_name=2, producer_version=3,
    # graph=7, opset_import=8 (OperatorSetIdProto{domain=1, version=2})
    return (_f_varint(1, 6)                       # IR version 6 (ONNX 1.6)
            + _f_str(2, "yolojax_torch")
            + _f_str(3, "round2")
            + _f_bytes(7, graph)
            + _f_bytes(8, _f_str(1, "") + _f_varint(2, opset)))


# ------------------------------------------------------ structural checker --


def _read_varint(buf: bytes, i: int) -> tuple:
    v = s = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, i
        s += 7


def _pb_fields(buf: bytes) -> dict:
    """Wire-format decode: {field: [value, ...]} (varint→int, LEN→bytes).
    Raises ``ValueError`` on any truncation (a blob cut mid-varint or inside
    a fixed32/fixed64/LEN payload), never IndexError."""
    out: dict = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            n, i = _read_varint(buf, i)
            if i + n > len(buf):
                raise ValueError("truncated LEN field")
            v = bytes(buf[i:i + n])
            i += n
        elif wire in (5, 1):
            n = 4 if wire == 5 else 8
            if i + n > len(buf):
                raise ValueError(f"truncated fixed{n * 8} field")
            v = bytes(buf[i:i + n])
            i += n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _check_value_info(vb: bytes, what: str) -> str:
    f = _pb_fields(vb)
    if 1 not in f:
        raise ValueError(f"{what}: ValueInfoProto missing name")
    name = f[1][0].decode()
    if 2 not in f:
        raise ValueError(f"{what} {name!r}: missing TypeProto")
    tt = _pb_fields(f[2][0])
    if 1 not in tt:
        raise ValueError(f"{what} {name!r}: TypeProto missing tensor_type")
    tensor = _pb_fields(tt[1][0])
    if 1 not in tensor:
        raise ValueError(f"{what} {name!r}: tensor_type missing elem_type")
    if 2 not in tensor:
        raise ValueError(f"{what} {name!r}: tensor_type missing shape")
    for dim in _pb_fields(tensor[2][0]).get(1, []):
        d = _pb_fields(dim)
        if 1 not in d and 2 not in d:
            raise ValueError(f"{what} {name!r}: dimension with no value/param")
    return name


_DTYPE_SIZE = {1: 4, 7: 8}  # FLOAT, INT64


def check_model(blob: bytes) -> dict:
    """Structural validation of an emitted ModelProto (no ``onnx`` needed).

    Checks the invariants ``onnx.checker`` would reject a file for: required
    ModelProto fields (ir_version, opset_import, graph), graph name, typed
    and shaped ValueInfo for every input/output, initializers with dims +
    dtype + raw_data of exactly the implied byte length, unique node output
    names, and topological order (every node input is a graph input, an
    initializer, or a previous node's output).  Returns a summary dict
    {ir_version, opset, nodes, initializers, inputs, outputs}.  Raises
    ``ValueError`` on the first violation.
    """
    m = _pb_fields(blob)
    for field, name in ((1, "ir_version"), (7, "graph"), (8, "opset_import")):
        if field not in m:
            raise ValueError(f"ModelProto missing {name}")
    ir = int(m[1][0])
    # the default-domain entry (field 1 absent or empty) carries the opset
    # version that matters; every entry must carry a version at all
    opsets = [_pb_fields(o) for o in m[8]]
    if not all(2 in o for o in opsets):
        raise ValueError("opset_import entry missing version")
    default = [o for o in opsets if not o.get(1, [b""])[0]]
    if not default:
        raise ValueError("opset_import missing the default-domain entry")
    opset = int(default[0][2][0])

    g = _pb_fields(m[7][0])
    if 2 not in g or not g[2][0]:
        raise ValueError("GraphProto missing name")
    inputs = [_check_value_info(v, "graph input") for v in g.get(11, [])]
    outputs = [_check_value_info(v, "graph output") for v in g.get(12, [])]
    if not inputs or not outputs:
        raise ValueError("graph must declare at least one input and output")

    known = set(inputs)
    inits = []
    for t in g.get(5, []):
        f = _pb_fields(t)
        if 8 not in f:
            raise ValueError("initializer missing name")
        name = f[8][0].decode()
        if 2 not in f:
            raise ValueError(f"initializer {name!r} missing data_type")
        dt = int(f[2][0])
        if dt not in _DTYPE_SIZE:
            raise ValueError(f"initializer {name!r}: unexpected dtype {dt}")
        dims = [int(d) for d in f.get(1, [b""]) if not isinstance(d, bytes)]
        if 1 in f and isinstance(f[1][0], bytes):   # packed repeated dims
            dims = []
            b = f[1][0]
            i = 0
            while i < len(b):
                v = s = 0
                while True:
                    c = b[i]
                    i += 1
                    v |= (c & 0x7F) << s
                    if not c & 0x80:
                        break
                    s += 7
                dims.append(v)
        if 9 not in f:
            raise ValueError(f"initializer {name!r} missing raw_data")
        n_elem = int(np.prod(dims)) if dims else 1
        want = n_elem * _DTYPE_SIZE[dt]
        if len(f[9][0]) != want:
            raise ValueError(f"initializer {name!r}: raw_data {len(f[9][0])}B, "
                             f"dims {dims} imply {want}B")
        inits.append(name)
        known.add(name)

    produced = set()
    nodes = []
    for nb in g.get(1, []):
        f = _pb_fields(nb)
        if 4 not in f:
            raise ValueError("NodeProto missing op_type")
        op = f[4][0].decode()
        node_inputs = [b.decode() for b in f.get(1, [])]
        node_outputs = [b.decode() for b in f.get(2, [])]
        if not node_outputs:
            raise ValueError(f"{op} node with no outputs")
        for i_name in node_inputs:
            if i_name not in known:
                raise ValueError(f"{op} node input {i_name!r} is not a graph "
                                 "input, initializer, or prior output "
                                 "(topological-order violation)")
        for o_name in node_outputs:
            if o_name in produced:
                raise ValueError(f"duplicate node output {o_name!r}")
            produced.add(o_name)
            known.add(o_name)
        nodes.append(op)
    for o_name in outputs:
        if o_name not in known:
            raise ValueError(f"graph output {o_name!r} is never produced")
    return {"ir_version": ir, "opset": opset, "nodes": len(nodes),
            "initializers": len(inits), "inputs": inputs, "outputs": outputs}
