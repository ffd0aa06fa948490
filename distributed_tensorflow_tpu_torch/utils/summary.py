"""Scalar summaries and TensorBoard event files.

Counterpart of ``distributed_tensorflow_tpu/utils/summary.py``. The
reference writes ``tf.summary.scalar("cost"/"accuracy")`` through a
``FileWriter('./logs')`` (reference ``tfsingle.py:55-57,69,81``). With no
TensorFlow here the ``tfevents`` wire format is written directly: TFRecord
framing (a length and masked CRC32C) around hand-encoded ``Event`` /
``Summary`` protobuf messages, which TensorBoard reads natively. For the
same scalars at the same wall time the records are the JAX package's byte
for byte.

The masked CRC (``_masked_crc``) takes the port's native CRC32C
(``runtime/native.py``) when it loads, and the pure table (:func:`crc32c`)
otherwise, as the JAX writer does.

The reference's ``FileWriter('./logs', graph=tf.get_default_graph())``
(``tfsingle.py:69``) dumped the graph; the JAX package dumps the train
step's jaxpr. Here :func:`graph_def_from_fn` traces the step the trainer
runs to an aten-level graph with ``torch.fx.experimental.proxy_tensor.
make_fx`` on fake tensors (nothing is launched on the card and no input is
read) and encodes it as a ``GraphDef``: one ``NodeDef`` a node, its op
name and output shape as attributes. A hand-written kernel stays one named
node: the flash operator through its fake implementation, the fused MLP
epoch through :func:`kernel_graph_def`.

:func:`lifecycle_event` fans one lifecycle signal out to stdout, the
journal and a tfevents scalar.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE: list[int] = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc_py(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord-masked CRC32C: the port's native runtime
    (``runtime/native.py``, built from ``runtime/csrc/dtf_crc32c.cc``) when
    it loads, the pure-Python table otherwise; both give the same value."""
    global _masked_crc_impl
    if _masked_crc_impl is None:
        try:
            from distributed_tensorflow_tpu_torch.runtime.native import crc32c_masked

            crc32c_masked(b"probe")  # load (or build) the library now
            _masked_crc_impl = crc32c_masked
        except (ImportError, OSError):
            _masked_crc_impl = _masked_crc_py
    return _masked_crc_impl(data)


_masked_crc_impl = None


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoders (only what Event/Summary need).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def _field_double(field: int, value: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(value)) + value


def _encode_scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    sval = _field_bytes(1, tag.encode()) + _field_float(2, value)
    # Summary { repeated Value value = 1; }
    summary = _field_bytes(1, sval)
    # Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
    return _field_double(1, wall_time) + _field_varint(2, step) + _field_bytes(5, summary)


def _encode_version_event(wall_time: float) -> bytes:
    # Event { double wall_time = 1; string file_version = 3; }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# ---------------------------------------------------------------------------
# FX graph → GraphDef (the reference's graph dump).
# ---------------------------------------------------------------------------

_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-/")


def _sanitize(name: str) -> str:
    return "".join(c if c in _NAME_OK else "_" for c in name) or "node"


def _attr_s(key: str, value: str) -> bytes:
    # map<string, AttrValue> entry { key = 1; AttrValue value = 2; }
    # AttrValue { bytes s = 2; }
    attr_value = _field_bytes(2, value.encode())
    return _field_bytes(5, _field_bytes(1, key.encode()) + _field_bytes(2, attr_value))


def _node_def(name: str, op: str, inputs: list[str], attrs: dict[str, str]) -> bytes:
    # NodeDef { string name = 1; string op = 2; repeated string input = 3;
    #           map<string, AttrValue> attr = 5; }
    out = _field_bytes(1, name.encode()) + _field_bytes(2, op.encode())
    for i in inputs:
        out += _field_bytes(3, i.encode())
    for k, v in attrs.items():
        out += _attr_s(k, v)
    return out


def _graph_def(nodes: list[bytes]) -> bytes:
    # GraphDef { repeated NodeDef node = 1; VersionDef versions = 4; }
    # VersionDef { int32 producer = 1; }
    return b"".join(_field_bytes(1, n) for n in nodes) + _field_bytes(4, _field_varint(1, 22))


def _shape_str(v) -> str:
    """``dtype[shape]`` of a traced value (a tensor, or the first of a
    tuple of them), as the JAX dump's ``output`` attribute reads."""
    if isinstance(v, (tuple, list)):
        v = next((x for x in v if hasattr(x, "shape")), None)
    if v is None or not hasattr(v, "shape"):
        return ""
    return "%s%s" % (str(v.dtype).replace("torch.", ""), list(v.shape))


def _op_name(target) -> str:
    """An operator's name without its overload: ``aten.mm``,
    ``dtf.FlashAttention``, ``getitem``."""
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return str(packet)
    return getattr(target, "__name__", str(target))


def graph_def_from_fx(gm) -> bytes:
    """Serialized ``GraphDef`` of an FX ``GraphModule``: a ``Placeholder``
    an input, a ``Const`` a captured constant, one node named
    ``<op>_<k>`` a call, its inputs the nodes it reads."""
    nodes, names = [], {}
    for k, n in enumerate(gm.graph.nodes):
        if n.op == "output":
            continue
        if n.op == "placeholder":
            name, op = _sanitize(n.name), "Placeholder"
        elif n.op == "get_attr":
            name, op = _sanitize(n.name), "Const"
        else:
            op = _op_name(n.target)
            name = _sanitize("%s_%d" % (op, k))
        names[n] = name
        attrs = {}
        shape = _shape_str(n.meta.get("val"))
        if shape:
            attrs["output"] = shape
        nodes.append(_node_def(name, op, [names[i] for i in n.all_input_nodes], attrs))
    return _graph_def(nodes)


def graph_def_from_fn(fn, *example_args) -> bytes:
    """Serialized ``GraphDef`` of ``fn(*example_args)`` traced by
    ``make_fx`` on fake tensors: the tensors' shapes and dtypes are read,
    their values never, and no operator runs on a device."""
    from torch.fx.experimental.proxy_tensor import make_fx

    # None arguments (an absent lengths tensor) stay out of the traced
    # signature: FX's code generation takes no None input.
    keep = [i for i, a in enumerate(example_args) if a is not None]

    def traced(*kept):
        args = list(example_args)
        for i, a in zip(keep, kept):
            args[i] = a
        return fn(*args)

    gm = make_fx(traced, tracing_mode="fake")(*(example_args[i] for i in keep))
    return graph_def_from_fx(gm)


def kernel_graph_def(kernel: str, inputs: dict) -> bytes:
    """A ``GraphDef`` of one opaque node: the hand-written kernel ``kernel``
    (named after its CUDA symbol) over ``inputs`` (name → tensor, each a
    ``Placeholder``). What a fused launch is in the graph, as a
    ``pallas_call`` equation is one node of a jaxpr."""
    nodes = [_node_def(_sanitize(k), "Placeholder", [], {"output": _shape_str(v)})
             for k, v in inputs.items()]
    nodes.append(_node_def(_sanitize(kernel), kernel, [_sanitize(k) for k in inputs], {}))
    return _graph_def(nodes)


def _encode_graph_event(wall_time: float, graph_def: bytes) -> bytes:
    # Event { double wall_time = 1; bytes graph_def = 4; }
    return _field_double(1, wall_time) + _field_bytes(4, graph_def)


_writers = 0


class SummaryWriter:
    """Drop-in for the reference's ``FileWriter('./logs')`` scalar usage."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        global _writers
        os.makedirs(logdir, exist_ok=True)
        # The pid and a count a process keep two writers of one second (the
        # ranks of a host, two runs of a process) off one file.
        _writers += 1
        fname = "events.out.tfevents.%010d.%s.%d.%d%s" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
            _writers,
            filename_suffix,
        )
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        self._write_record(_encode_version_event(time.time()))

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _encode_scalar_event(time.time(), int(step), tag, float(value))
        )

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_graph(self, fn, *example_args) -> None:
        """Dump ``fn``'s traced graph as a TensorBoard graph (reference
        tfsingle.py:69 passed the TF graph to the FileWriter)."""
        self.add_graph_def(graph_def_from_fn(fn, *example_args))

    def add_graph_def(self, graph_def: bytes) -> None:
        """Write a serialized ``GraphDef`` as the run's graph event."""
        self._write_record(_encode_graph_event(time.time(), graph_def))

    def flush(self) -> None:
        # fsync, not just flush: the records flushed at a run's end must
        # survive the process being killed right after.
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:  # pragma: no cover — exotic filesystems
            pass

    def close(self) -> None:
        self.flush()
        self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Lifecycle emitter: one call for the three-way fan-out of a lifecycle signal
# (stdout line, journal event, tfevents scalar). The line wording lives in
# observability/format.py.
# ---------------------------------------------------------------------------


def lifecycle_event(
    kind: str,
    *,
    print_fn=None,
    journal=None,
    writer: "SummaryWriter | None" = None,
    scalar: tuple | None = None,
    **fields,
) -> dict:
    """Emit one lifecycle signal everywhere it belongs:

    - a typed journal event (``observability.format.emit_line``; the
      process-default :class:`~observability.journal.NullJournal` when no
      journal is attached),
    - the structured stdout line rendered FROM that event (byte-identical
      to the pre-journal wording) via ``print_fn``,
    - and, when ``writer`` and ``scalar=(tag, value, step)`` are given,
      the tfevents scalar the TensorBoard surface keeps showing.

    Returns the event dict.
    """
    from distributed_tensorflow_tpu_torch.observability import format as obs_format

    ev = obs_format.emit_line(
        kind, journal=journal, print_fn=print_fn, **fields
    )
    if writer is not None and scalar is not None:
        tag, value, step = scalar
        writer.add_scalar(tag, float(value), int(step))
    return ev
