"""Nested Parquet columns: lists, structs and maps through repetition and
definition levels (the port's own; the reference reads and writes them
through pyarrow).

Schema: a top-level group annotated LIST is Arrow's three-level list (a
repeated group holding one ``element``), a group annotated MAP (or
MAP_KEY_VALUE) a repeated ``key_value`` group of ``key`` and ``value``, any
other group a struct; ``build_node`` makes a ``PNode`` tree with each
node's definition level (the levels of the optional and repeated nodes
down to it) and each list's repetition level. A legacy two-level list or a
bare repeated field raises NotImplementedError naming it.

Reading (``read_nested``): each leaf chunk's pages give its repetition and
definition levels (the RLE / bit-packed hybrid) and the values of the
entries defined down to the leaf. A column is assembled from the top:
a row starts at each entry of repetition level 0; a list's elements start
at the entries defined down to its repeated node whose repetition level is
at most the list's, and its offsets are where its rows' first entries fall
among them; a struct's rows are its parent's; a leaf row is valid where its
entry is defined down to it. All of it is numpy over the level arrays.

Writing (``shred``): the inverse, per leaf path: every row an entry, each
list expanding its entries into its elements (the first keeping the
entry's repetition level, the others taking the list's), the definition
level counting each node an entry is defined through. Leaves are written
in data page v1, pages split between rows: strings dictionary-encoded (a
leaf that carries dictionary codes keeps them; PLAIN past a 1 MiB
dictionary), the rest PLAIN. A string leaf read from dictionary pages
carries its codes, as a flat one does. Statistics of a nested leaf are
not written or read.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.series import Series, _lengths_to_offsets
from ..datatype import DataType
from . import _thrift as th

REQUIRED, OPTIONAL, REPEATED = range(3)
_LIST, _MAP, _MAP_KEY_VALUE = 3, 1, 2


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"Parquet {what} is not supported by the port")


@dataclasses.dataclass
class PNode:
    name: str
    kind: str          # "leaf", "struct", "list" or "map"
    optional: bool
    def_level: int     # the definition level of an entry defined down to this node
    rep_level: int     # the repetition level of this node's repeated ancestors
    dtype: DataType
    children: List["PNode"] = dataclasses.field(default_factory=list)
    # a list or a map: the definition level of an entry with an element
    elem_def: int = 0
    # a leaf: its schema element and its path from the top-level field
    element: Optional[Dict[str, Any]] = None
    path: Tuple[str, ...] = ()

    def leaves(self) -> List["PNode"]:
        if self.kind == "leaf":
            return [self]
        return [leaf for c in self.children for leaf in c.leaves()]

    def first_leaf(self) -> "PNode":
        return self.leaves()[0]


def top_level_fields(schema: List[Dict[str, Any]]):
    """(schema element, the elements of its subtree) of each root child."""
    if not schema:
        raise ValueError("Parquet footer has no schema")
    out = []
    i = 1
    for _ in range(schema[0].get("num_children") or 0):
        j = _subtree_end(schema, i)
        out.append((schema[i], schema[i:j]))
        i = j
    return out


def _subtree_end(schema, i: int) -> int:
    todo = 1
    while todo:
        todo += (schema[i].get("num_children") or 0) - 1
        i += 1
    return i


def _annotation(el) -> Optional[str]:
    logical = el.get("logicalType") or {}
    conv = el.get("converted_type")
    if "LIST" in logical or conv == _LIST:
        return "list"
    if "MAP" in logical or conv in (_MAP, _MAP_KEY_VALUE):
        return "map"
    return None


def build_node(els: List[Dict[str, Any]], i: int, def_level: int, rep_level: int,
               path: Tuple[str, ...] = ()):
    """(the PNode of the element at ``els[i]``, the index after its subtree)."""
    from ._parquet_format import _port_dtype

    el = els[i]
    name = el.get("name")
    rep = el.get("repetition_type", REQUIRED)
    path = path + (name,)
    if rep == REPEATED:
        raise _unsupported(f"repeated field {'.'.join(path)!r} outside a LIST or MAP "
                           "(a legacy two-level list)")
    optional = rep == OPTIONAL
    d = def_level + optional
    nkids = el.get("num_children") or 0
    if not nkids:
        dtype, scale = _port_dtype(el)
        node = PNode(name, "leaf", optional, d, rep_level, dtype, element=el, path=path)
        node.scale = scale
        return node, i + 1
    ann = _annotation(el)
    if ann is not None:
        if nkids != 1:
            raise _unsupported(f"{ann.upper()} group {name!r} of {nkids} children")
        inner = els[i + 1]
        if inner.get("repetition_type") != REPEATED or not inner.get("num_children"):
            raise _unsupported(f"{ann.upper()} group {name!r} without a repeated group "
                               "(a legacy two-level list)")
        rep_path = path + (inner.get("name"),)
        j = i + 2
        kids = []
        for _ in range(inner["num_children"]):
            kid, j = build_node(els, j, d + 1, rep_level + 1, rep_path)
            kids.append(kid)
        if ann == "list":
            if len(kids) != 1:
                raise _unsupported(f"LIST group {name!r} whose repeated group has "
                                   f"{len(kids)} fields (a legacy two-level list)")
            node = PNode(name, "list", optional, d, rep_level + 1, DataType.list(kids[0].dtype),
                         kids, elem_def=d + 1, path=path)
        else:
            if len(kids) != 2:
                raise _unsupported(f"MAP group {name!r} of {len(kids)} key-value fields")
            entry = PNode("key_value", "struct", False, d + 1, rep_level + 1,
                          DataType.struct([("key", kids[0].dtype), ("value", kids[1].dtype)]),
                          kids, path=rep_path)
            node = PNode(name, "map", optional, d, rep_level + 1,
                         DataType.map(kids[0].dtype, kids[1].dtype), [entry], elem_def=d + 1,
                         path=path)
        return node, j
    j = i + 1
    kids = []
    for _ in range(nkids):
        kid, j = build_node(els, j, d, rep_level, path)
        kids.append(kid)
    return PNode(name, "struct", optional, d, rep_level,
                 DataType.struct([(k.name, k.dtype) for k in kids]), kids, path=path), j


def reconcile(dtype: DataType, arrow: Optional[DataType]) -> DataType:
    """The Parquet schema's type with what the file's ARROW:schema adds: a
    fixed-size list where Parquet has a list, a duration where it has an
    int64, a timestamp's zone."""
    if arrow is None or not isinstance(arrow, DataType):
        return dtype
    k = dtype.kind
    if k == "list" and arrow.kind in ("list", "fixed_size_list"):
        inner = reconcile(dtype.inner, arrow.inner)
        return DataType.fixed_size_list(inner, arrow.size) if arrow.kind == "fixed_size_list" \
            else DataType.list(inner)
    if k == "struct" and arrow.kind == "struct" \
            and len(arrow.struct_fields) == len(dtype.struct_fields):
        return DataType.struct([(n, reconcile(t, a)) for (n, t), (_an, a)
                                in zip(dtype.struct_fields, arrow.struct_fields)])
    if k == "map" and arrow.kind == "map":
        return DataType.map(reconcile(dtype.params[0], arrow.params[0]),
                            reconcile(dtype.params[1], arrow.params[1]))
    if k == "int64" and arrow.kind == "duration":
        return arrow
    if k == "timestamp" and arrow.kind == "timestamp" and dtype.timezone is not None \
            and arrow.timezone is not None:
        return DataType.timestamp(dtype.time_unit, arrow.timezone)
    return dtype


# ---- reading -----------------------------------------------------------------------------


def _bit_width(level: int) -> int:
    return int(level).bit_length()


def read_leaf(f, md: Dict[str, Any], leaf: PNode, codec_col):
    """(values of the entries defined down to the leaf, definition levels,
    repetition levels, (dictionary, indices) where every page was
    dictionary-encoded, else None) of one leaf chunk."""
    from . import _parquet_format as pf
    from .codecs import decompress

    codec = md.get("codec", 0)
    start = md["data_page_offset"]
    dict_off = md.get("dictionary_page_offset")
    if dict_off is not None and 0 < dict_off < start:
        start = dict_off
    f.seek(start)
    raw = f.read(md["total_compressed_size"])
    total = md["num_values"]
    max_def, max_rep = leaf.def_level, leaf.rep_level
    dw, rw = _bit_width(max_def), _bit_width(max_rep)
    pos = seen = 0
    dictionary = None
    values, defs_all, reps_all, indices = [], [], [], []
    while seen < total:
        if pos >= len(raw):
            raise ValueError(f"column {'.'.join(leaf.path)!r}: chunk ends after {seen} of "
                             f"{total} values")
        hraw, pos = th.read_struct(raw, pos)
        ph = th.decode(th.PAGE_HEADER, hraw)
        size = ph["compressed_page_size"]
        page = raw[pos:pos + size]
        pos += size
        kind = ph["type"]
        if kind == pf.DICTIONARY_PAGE:
            dh = ph.get("dictionary_page_header") or {}
            if dh.get("encoding", pf.PLAIN) not in (pf.PLAIN, pf.PLAIN_DICTIONARY):
                raise _unsupported(f"dictionary page encoding "
                                   f"{pf.ENCODING_NAMES.get(dh.get('encoding'))}")
            data = decompress(codec, page, ph["uncompressed_page_size"])
            dictionary = pf._to_port(pf.decode_plain(
                data, 0, codec_col.physical, dh.get("num_values", 0),
                codec_col.dtype.is_binary(), codec_col.width)[0], codec_col)
            continue
        if kind == pf.DATA_PAGE:
            dh = ph["data_page_header"]
            n = dh["num_values"]
            data = decompress(codec, page, ph["uncompressed_page_size"])
            p = 0
            reps = np.zeros(n, dtype=np.int64)
            defs = np.full(n, max_def, dtype=np.int64)
            if max_rep:
                ln = struct.unpack_from("<I", data, p)[0]
                reps = pf.decode_hybrid(data, p + 4, p + 4 + ln, rw, n)
                p += 4 + ln
            if max_def:
                ln = struct.unpack_from("<I", data, p)[0]
                defs = pf.decode_hybrid(data, p + 4, p + 4 + ln, dw, n)
                p += 4 + ln
            encoding = dh["encoding"]
        elif kind == pf.DATA_PAGE_V2:
            dh = ph["data_page_header_v2"]
            n = dh["num_values"]
            rl = dh.get("repetition_levels_byte_length", 0)
            dl = dh.get("definition_levels_byte_length", 0)
            reps = pf.decode_hybrid(page, 0, rl, rw, n) if max_rep \
                else np.zeros(n, dtype=np.int64)
            defs = pf.decode_hybrid(page, rl, rl + dl, dw, n) if max_def \
                else np.full(n, max_def, dtype=np.int64)
            body = page[rl + dl:]
            if dh.get("is_compressed", True):
                body = decompress(codec, body, ph["uncompressed_page_size"] - rl - dl)
            data, p = body, 0
            encoding = dh["encoding"]
        else:
            continue
        nvals = int((defs == max_def).sum())
        if encoding in (pf.PLAIN_DICTIONARY, pf.RLE_DICTIONARY):
            idx = pf._dictionary_indices(data, p, codec_col, nvals, dictionary)
            values.append(dictionary[idx])
            indices.append(idx)
        else:
            indices.append(None)
            values.append(pf._to_port(pf._decode_values(data, p, encoding, codec_col, nvals),
                                      codec_col))
        defs_all.append(defs)
        reps_all.append(reps)
        seen += n
    np_dt = leaf.dtype.to_numpy()
    vals = np.concatenate(values) if values else np.zeros(0, dtype=np_dt)
    coded = None
    if dictionary is not None and indices and all(i is not None for i in indices):
        coded = (dictionary, np.concatenate(indices))
    return (vals, np.concatenate(defs_all) if defs_all else np.zeros(0, np.int64),
            np.concatenate(reps_all) if reps_all else np.zeros(0, np.int64), coded)


def _leaf_series(leaf: PNode, dtype: DataType, levels, starts: np.ndarray) -> Series:
    from ..core.series import _null_fill
    from ._parquet_format import attach_dictionary_codes

    vals, defs, _reps, coded = levels
    d = defs[starts]
    valid = d >= leaf.def_level
    vidx = np.cumsum(defs == leaf.def_level) - 1
    take = vidx[starts[valid]]
    np_dt = dtype.to_numpy()
    out = np.empty(len(starts), dtype=np_dt)
    out[:] = None if np_dt == object else _null_fill(dtype)
    if len(take):
        out[valid] = vals[take]
    s = Series(leaf.name, dtype, out, valid)
    if coded is not None and dtype.is_string():
        attach_dictionary_codes(s, coded[0], coded[1][take])
    return s


def _assemble(node: PNode, dtype: DataType, levels: Dict[Tuple[str, ...], tuple],
              starts: Dict[Tuple[str, ...], np.ndarray]) -> Series:
    if node.kind == "leaf":
        return _leaf_series(node, dtype, levels[node.path], starts[node.path])
    first = node.first_leaf().path
    defs0 = levels[first][1]
    st0 = starts[first]
    valid = defs0[st0] >= node.def_level
    if node.kind == "struct":
        kids = [_assemble(c, t, levels, starts)
                for c, (_n, t) in zip(node.children, dtype.struct_fields)]
        return Series.nested(node.name, dtype, None, kids, valid)
    # a list or a map: its elements start where an entry is defined down to the
    # repeated node at a repetition level no deeper than the list's
    kid_starts = {}
    for leaf in node.leaves():
        _v, defs, reps, _c = levels[leaf.path]
        kid_starts[leaf.path] = np.flatnonzero((defs >= node.elem_def)
                                               & (reps <= node.rep_level))
    cs = kid_starts[first]
    offsets = np.empty(len(st0) + 1, dtype=np.int64)
    offsets[:-1] = np.searchsorted(cs, st0)
    offsets[-1] = len(cs)
    elem = node.children[0]
    if node.kind == "map":
        child = _assemble(elem, dtype.map_entry, levels, kid_starts)
        out_dt = dtype
    else:
        inner = dtype.inner
        child = _assemble(elem, inner, levels, kid_starts)
        out_dt = DataType.list(inner) if dtype.kind == "fixed_size_list" else dtype
    out = Series.nested(node.name, out_dt, offsets, [child], valid)
    return out.cast(dtype) if out_dt != dtype else out


def read_nested(f, footer, rg, col) -> Series:
    """The Series of a nested column in row group ``rg``."""
    from ._parquet_format import ColumnInfo

    levels = {}
    starts = {}
    for leaf in col.node.leaves():
        md = footer.chunk_by_path(rg, leaf.path)
        el = leaf.element
        codec_col = ColumnInfo(".".join(leaf.path), el.get("type"), leaf.dtype,
                               leaf.def_level, getattr(leaf, "scale", 1), None,
                               int(el.get("type_length") or 0))
        levels[leaf.path] = read_leaf(f, md, leaf, codec_col)
        starts[leaf.path] = np.flatnonzero(levels[leaf.path][2] == 0)
    out = _assemble(col.node, col.dtype, levels, starts)
    n = int(rg["num_rows"])
    if len(out) != n:
        raise ValueError(f"column {col.name!r}: {len(out)} rows read, {n} declared")
    return out.rename(col.name)


# ---- writing -----------------------------------------------------------------------------


def schema_elements(name: str, dtype: DataType, optional: bool = True) -> List[Dict[str, Any]]:
    """The Parquet schema elements of a field, as pyarrow writes them (a list
    as LIST / ``list`` / ``element``, a map as MAP / ``key_value`` with a
    required ``key``)."""
    from ._parquet_format import _physical_for

    rep = OPTIONAL if optional else REQUIRED
    k = dtype.kind
    if k in ("list", "fixed_size_list"):
        return [{"repetition_type": rep, "name": name, "num_children": 1,
                 "converted_type": _LIST, "logicalType": {"LIST": {}}},
                {"repetition_type": REPEATED, "name": "list", "num_children": 1}] + \
            schema_elements("element", dtype.inner)
    if k == "map":
        key_dt, val_dt = dtype.params
        return [{"repetition_type": rep, "name": name, "num_children": 1,
                 "converted_type": _MAP, "logicalType": {"MAP": {}}},
                {"repetition_type": REPEATED, "name": "key_value", "num_children": 2}] + \
            schema_elements("key", key_dt, optional=False) + schema_elements("value", val_dt)
    if k == "struct":
        out = [{"repetition_type": rep, "name": name,
                "num_children": len(dtype.struct_fields)}]
        for fname, fdt in dtype.struct_fields:
            out += schema_elements(fname, fdt)
        return out
    physical, ann, _scale = _physical_for(dtype)
    return [{"type": physical, "repetition_type": rep, "name": name, **ann}]


def _leaf_paths(name: str, dtype: DataType, optional: bool = True):
    """(path, [(step, optional)], leaf dtype) of each leaf of a field: a step
    is "opt" (an optional node), "list" / "map" (the repeated level) or a
    struct field's name."""
    k = dtype.kind
    own = [("opt", None)] if optional else []
    if k in ("list", "fixed_size_list"):
        for p, steps, t in _leaf_paths("element", dtype.inner):
            yield (name, "list") + p, own + [("list", None)] + steps, t
    elif k == "map":
        key_dt, val_dt = dtype.params
        for i, (sub, sdt, opt) in enumerate((("key", key_dt, False),
                                             ("value", val_dt, True))):
            for p, steps, t in _leaf_paths(sub, sdt, opt):
                yield (name, "key_value") + p, own + [("map", i)] + steps, t
    elif k == "struct":
        for i, (fname, fdt) in enumerate(dtype.struct_fields):
            for p, steps, t in _leaf_paths(fname, fdt):
                yield (name,) + p, own + [("field", i)] + steps, t
    else:
        yield (name,), own, dtype


def shred(s: Series, steps) -> Tuple[Series, np.ndarray, np.ndarray, np.ndarray]:
    """(the leaf column, the rows of it each defined entry holds, definition
    levels, repetition levels) of one leaf path of ``s``."""
    n = len(s)
    idx = np.arange(n, dtype=np.int64)
    defs = np.zeros(n, dtype=np.int64)
    reps = np.zeros(n, dtype=np.int64)
    rep_level = 0
    cur = s
    for kind, arg in steps:
        live = idx >= 0
        if kind == "opt":
            ok = np.zeros(len(idx), dtype=bool)
            ok[live] = cur.validity_numpy()[idx[live]]
            defs = defs + ok
            idx = np.where(ok, idx, -1)
        elif kind == "field":
            cur = cur.layout.children[arg]
        else:  # a list's or a map's repeated level
            rep_level += 1
            lens = np.zeros(len(idx), dtype=np.int64)
            lens[live] = cur.list_lengths()[idx[live]]
            grow = lens > 0
            counts = np.where(grow, lens, 1)
            first = _lengths_to_offsets(counts)[:-1]
            pos = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(first, counts)
            base = np.where(grow, cur.list_offsets()[:-1][np.where(live, idx, 0)]
                            if len(cur) else 0, -1)
            g = np.repeat(grow, counts)
            idx = np.where(g, np.repeat(base, counts) + pos, -1)
            defs = np.repeat(defs, counts) + g
            reps = np.where(pos > 0, rep_level, np.repeat(reps, counts))
            cur = cur.list_child()
            if kind == "map":
                cur = cur.layout.children[arg]
    return cur, idx, defs, reps


def write_nested_column(f, s: Series, codec: int, page_entries: int = 1 << 20):
    """Write each leaf chunk of the nested column ``s``; their
    ColumnMetaData."""
    from . import _parquet_format as pf
    from .codecs import compress

    out = []
    for path, steps, leaf_dt in _leaf_paths(s.name, s.dtype):
        leaf, idx, defs, reps = shred(s, steps)
        max_def = sum(1 for k, _a in steps if k in ("opt", "list", "map"))
        max_rep = sum(1 for k, _a in steps if k in ("list", "map"))
        physical, _ann, scale = pf._physical_for(leaf_dt)
        col = pf.ColumnInfo(".".join(path), physical, leaf_dt, max_def, scale, None,
                            leaf_dt.size if leaf_dt.kind == "fixed_size_binary" else 0)
        defined = defs == max_def
        rows = idx[defined]
        vals = leaf.to_numpy()[rows] if len(leaf) else np.zeros(0, dtype=leaf_dt.to_numpy())
        store = pf._storage(vals, col)
        start = f.tell()
        total = 0
        dictionary = _leaf_dictionary(leaf, rows, vals) if leaf_dt.is_string() and len(vals) \
            else None
        encodings = {pf.PLAIN, pf.RLE}
        dict_offset = None
        if dictionary is not None:
            words, codes = dictionary
            body = pf.encode_plain(words, physical)
            comp = compress(codec, body)
            head = pf._page_header(pf.DICTIONARY_PAGE, len(body), len(comp),
                                   dictionary_page_header={"num_values": len(words),
                                                           "encoding": pf.PLAIN})
            dict_offset = start
            f.write(head)
            f.write(comp)
            total += len(head) + len(body)
            encodings.add(pf.RLE_DICTIONARY)
            bw = max(1, (len(words) - 1).bit_length())
        data_offset = f.tell()
        row_starts = np.flatnonzero(reps == 0)
        bounds = [0]
        if len(reps) > page_entries:
            # pages break between rows, about page_entries entries each
            at = np.searchsorted(row_starts, np.arange(page_entries, len(reps), page_entries))
            cut = np.unique(row_starts[np.minimum(at, len(row_starts) - 1)])
            bounds += [int(c) for c in cut if c > 0]
        bounds.append(len(reps))
        v0 = 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            nv = int(defined[a:b].sum())
            body = b""
            if max_rep:
                lv = pf.encode_hybrid(reps[a:b], _bit_width(max_rep))
                body += struct.pack("<I", len(lv)) + lv
            if max_def:
                lv = pf.encode_hybrid(defs[a:b], _bit_width(max_def))
                body += struct.pack("<I", len(lv)) + lv
            if dictionary is not None:
                body += bytes([bw]) + pf.encode_hybrid(codes[v0:v0 + nv], bw)
            else:
                body += pf.encode_plain(store[v0:v0 + nv], physical)
            v0 += nv
            comp = compress(codec, body)
            head = pf._page_header(pf.DATA_PAGE, len(body), len(comp),
                                   data_page_header={"num_values": b - a,
                                                     "encoding": pf.RLE_DICTIONARY
                                                     if dictionary is not None else pf.PLAIN,
                                                     "definition_level_encoding": pf.RLE,
                                                     "repetition_level_encoding": pf.RLE})
            f.write(head)
            f.write(comp)
            total += len(head) + len(body)
        md = {"type": physical, "encodings": sorted(encodings),
              "path_in_schema": list(path), "codec": codec, "num_values": len(reps),
              "total_uncompressed_size": total,
              "total_compressed_size": f.tell() - start, "data_page_offset": data_offset,
              "statistics": {"null_count": int((~defined).sum())}}
        if dict_offset is not None:
            md["dictionary_page_offset"] = dict_offset
        out.append(md)
    return out


def _leaf_dictionary(leaf: Series, rows: np.ndarray, vals: np.ndarray):
    """(dictionary words, each defined value's code) of a string leaf: its
    own dictionary codes where it carries them, else the values'
    first-occurrence dictionary; None past the 1 MiB dictionary limit."""
    from . import _parquet_format as pf

    raw = leaf._raw_codes()
    if raw is not None and len(raw[1]) <= max(len(rows), 1):
        codes, words = raw
        out = np.empty(len(words), dtype=object)
        out[:] = ["" if w is None else w for w in words]
        if sum(map(len, out.tolist())) + 4 * len(out) <= pf.DICTIONARY_LIMIT_BYTES:
            return out, np.asarray(codes, dtype=np.int64)[rows]
    return pf._string_dictionary(vals)
