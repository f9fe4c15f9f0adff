"""Readers of the raw releases: meshes, superpixels, molecules, RDF.

Counterpart of ``pytorch_geometric_tpu/datasets/io.py`` (reference:
torch_geometric.io.read_off / read_ply, the torch-saved tuples of PyG's
MNISTSuperpixels raw files, the GDB-9 ``.xyz`` records of QM9 and the
N-Triples of the RDF entity corpora). Host-side numpy parsing, the JAX
package's code: OFF text; PLY in ascii and binary_little_endian; zip
and tar members (macOS resource forks skipped).

``load_torch_tuple`` loads with ``torch.load(..., weights_only=True)``:
the port unpickles no arbitrary object. PyG's raw ``.pt`` files are
tuples of tensors, which load that way.
"""

import os.path as osp
import zipfile

import numpy as np
import torch


def read_off(path_or_lines):
    """Parse an OFF mesh -> (pos (V, 3) float32, face (3, F) int64)."""
    if isinstance(path_or_lines, (str, bytes)) and osp.exists(
            path_or_lines):
        with open(path_or_lines, "r") as fh:
            raw = fh.read()
    elif isinstance(path_or_lines, bytes):
        raw = path_or_lines.decode()
    else:
        raw = path_or_lines
    tokens = []
    for line in raw.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            tokens.extend(line.split())
    assert tokens[0].startswith("OFF"), "not an OFF file"
    # some ModelNet files glue counts onto the OFF line: "OFF490 518 0"
    if tokens[0] != "OFF":
        tokens = [tokens[0][3:]] + tokens[1:]
    else:
        tokens = tokens[1:]
    nv, nf = int(tokens[0]), int(tokens[1])
    ptr = 3
    pos = np.asarray(tokens[ptr: ptr + 3 * nv],
                     dtype=np.float32).reshape(nv, 3)
    ptr += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[ptr])
        idx = [int(t) for t in tokens[ptr + 1: ptr + 1 + k]]
        ptr += 1 + k
        for i in range(1, k - 1):        # fan-triangulate polygons
            faces.append((idx[0], idx[i], idx[i + 1]))
    face = (np.asarray(faces, dtype=np.int64).T if faces
            else np.zeros((3, 0), np.int64))
    return pos, face


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path_or_bytes):
    """Parse a PLY mesh -> (pos (V, 3) float32, face (3, F) int64).

    Supports ascii and binary_little_endian; vertex properties x/y/z
    plus a face list property (vertex_indices / vertex_index).
    """
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as fh:
            blob = fh.read()
    else:
        blob = path_or_bytes
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:end].decode("ascii").splitlines()
    body = blob[end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, list_count_dtype)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _PLY_DTYPES[parts[3]],
                     _PLY_DTYPES[parts[2]]))
            else:
                elements[-1][2].append(
                    (parts[2], _PLY_DTYPES[parts[1]], None))

    pos, face = None, np.zeros((3, 0), np.int64)
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        ptr = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(tokens[ptr: ptr + count * width],
                                 dtype=np.float32).reshape(count, width)
                cols = [p[0] for p in props]
                pos = arr[:, [cols.index("x"), cols.index("y"),
                              cols.index("z")]]
                ptr += count * width
            elif name == "face":
                faces = []
                for _ in range(count):
                    k = int(tokens[ptr])
                    idx = [int(t) for t in tokens[ptr + 1: ptr + 1 + k]]
                    ptr += 1 + k
                    for i in range(1, k - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
                face = np.asarray(faces, np.int64).T if faces else face
            else:  # skip unknown fixed-width element
                ptr += count * len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                pos = np.stack([arr["x"], arr["y"], arr["z"]],
                               axis=1).astype(np.float32)
                off += dt.itemsize * count
            elif name == "face":
                faces = []
                for _ in range(count):
                    cnt_dt = np.dtype("<" + props[0][2])
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx_dt = np.dtype("<" + props[0][1])
                    idx = np.frombuffer(body, idx_dt, k, off)
                    off += idx_dt.itemsize * k
                    for i in range(1, k - 1):
                        faces.append((int(idx[0]), int(idx[i]),
                                      int(idx[i + 1])))
                face = np.asarray(faces, np.int64).T if faces else face
            else:
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                off += dt.itemsize * count
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return pos, face


def load_torch_tuple(path):
    """A torch-saved tuple of tensors (PyG's raw ``.pt`` files) as numpy
    arrays, loaded with ``weights_only=True``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)

    def to_np(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, (list, tuple)):
            return type(x)(to_np(v) for v in x)
        return x

    return to_np(obj)


def iter_zip_members(zip_path, suffix):
    """Yield (name, bytes) for members of a zip archive with suffix.

    macOS-built archives (the official ModelNet10/40 zips among them)
    carry ``__MACOSX/`` resource-fork mirrors and ``._*`` AppleDouble
    entries whose names match real members' suffixes but whose bytes
    are not the advertised format; skip them unconditionally.
    """
    with zipfile.ZipFile(zip_path) as zf:
        for name in sorted(zf.namelist()):
            base = name.rsplit("/", 1)[-1]
            if name.startswith("__MACOSX/") or base.startswith("._"):
                continue
            if name.endswith(suffix):
                yield name, zf.read(name)


def iter_tar_members(tar_path, suffix):
    """Yield (name, bytes) for members of a tar archive (any
    compression) with the given suffix, AppleDouble entries skipped."""
    import tarfile

    with tarfile.open(tar_path) as tf:
        for m in tf.getmembers():
            base = m.name.rsplit("/", 1)[-1]
            if not m.isfile() or m.name.startswith("__MACOSX/") \
                    or base.startswith("._"):
                continue
            if m.name.endswith(suffix):
                yield m.name, tf.extractfile(m).read()


_QM9_ELEMENTS = ("H", "C", "N", "O", "F")


def read_qm9_xyz(text):
    """Parse one GDB-9 .xyz record (the format of dsgdb9nsd.xyz.tar.bz2:
    natoms / 'gdb <id> <15 scalar properties>' / natoms atom lines
    'symbol x y z charge' with '*^' exponent quirks / frequencies /
    SMILES / InChI).

    Returns (x one-hot(5 elements), pos (n,3), y (1,19)) — y columns
    0..11 are [mu, alpha, homo, lumo, gap, r2, zpve, U0, U, H, G, Cv]
    (so the reference example's target 0 = dipole moment,
    examples/qm9_nn_conv.py:55-57), 12..14 the rotational constants
    A, B, C, remainder zero-padded.
    """
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="ignore")
    lines = text.splitlines()
    n = int(lines[0].strip())
    props = lines[1].replace("\t", " ").split()
    vals = [float(v.replace("*^", "e")) for v in props[2:17]]
    a_b_c, scalars = vals[:3], vals[3:]          # A B C then mu..Cv
    y = np.zeros((1, 19), np.float32)
    y[0, : len(scalars)] = scalars
    y[0, 12:15] = a_b_c
    x = np.zeros((n, len(_QM9_ELEMENTS)), np.float32)
    pos = np.zeros((n, 3), np.float32)
    for i in range(n):
        f = lines[2 + i].replace("\t", " ").split()
        x[i, _QM9_ELEMENTS.index(f[0])] = 1.0
        pos[i] = [float(v.replace("*^", "e")) for v in f[1:4]]
    return x, pos, y


def qm9_distance_bonds(pos, cutoff: float = 1.7):
    """Bond guess by interatomic distance (the xyz release carries no
    bond table; the reference pipeline rebuilds a complete edge set +
    Distance attributes anyway, examples/qm9_nn_conv.py:24-51).
    Returns (edge_index (2, E) both directions, edge_attr one-hot(4)
    distance bins)."""
    n = pos.shape[0]
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    s, r = np.nonzero((d < cutoff) & (d > 1e-6))
    if len(s) == 0:                               # lone atom: self loop
        s = r = np.zeros(1, np.int64)
    bins = np.clip((d[s, r] / (cutoff / 4)).astype(np.int64), 0, 3)
    ea = np.eye(4, dtype=np.float32)[bins]
    return np.stack([s, r]), ea


def parse_ntriples(text):
    """Minimal N-Triples reader: yields (subject, predicate, object)
    term strings (URIs without <>, literals with quotes stripped)."""
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="ignore")
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        terms = []
        i = 0
        while i < len(line) and len(terms) < 3:
            if line[i] == "<":
                j = line.index(">", i)
                terms.append(line[i + 1: j])
                i = j + 1
            elif line[i] == '"':
                j = i + 1
                while j < len(line):
                    if line[j] == '"' and line[j - 1] != "\\":
                        break
                    j += 1
                lit = line[i + 1: j]
                # skip datatype/lang suffix up to next whitespace
                j += 1
                while j < len(line) and line[j] not in " \t":
                    j += 1
                terms.append(lit)
                i = j
            elif line[i] in " \t.":
                i += 1
            else:                                  # blank node _:b0
                j = i
                while j < len(line) and line[j] not in " \t":
                    j += 1
                terms.append(line[i:j])
                i = j
        if len(terms) == 3:
            yield tuple(terms)


def parse_entities_rdf(nt_text, train_tsv, test_tsv, entity_col,
                       label_col):
    """RDF entity-classification corpus -> arrays (the PyG Entities
    recipe, reference examples/rgcn.py:11): every subject/object is a
    node, every predicate a relation; edges are added in both
    directions with relation ids 2r / 2r+1; labels come from the
    train/test TSVs' (entity_col, label_col) columns."""
    import csv
    import io as _io

    triples = list(parse_ntriples(nt_text))
    nodes, rels = {}, {}
    for s, p, o in triples:
        nodes.setdefault(s, len(nodes))
        nodes.setdefault(o, len(nodes))
        rels.setdefault(p, len(rels))
    src, dst, et = [], [], []
    for s, p, o in triples:
        a, b, r = nodes[s], nodes[o], rels[p]
        src += [a, b]
        dst += [b, a]
        et += [2 * r, 2 * r + 1]

    def read_split(tsv):
        if isinstance(tsv, bytes):
            tsv = tsv.decode("utf-8")
        rows = list(csv.DictReader(_io.StringIO(tsv), delimiter="\t"))
        idx, labs = [], []
        for row in rows:
            ent = row[entity_col]
            if ent in nodes:
                idx.append(nodes[ent])
                labs.append(row[label_col])
        return idx, labs

    tr_idx, tr_lab = read_split(train_tsv)
    te_idx, te_lab = read_split(test_tsv)
    classes = {c: i for i, c in enumerate(sorted(set(tr_lab + te_lab)))}
    n = len(nodes)
    y = np.full(n, -1, dtype=np.int64)
    for i, lab in zip(tr_idx + te_idx, tr_lab + te_lab):
        y[i] = classes[lab]
    return dict(edge_index=np.stack([np.asarray(src), np.asarray(dst)]),
                edge_type=np.asarray(et, np.int64), y=y,
                train_idx=np.asarray(tr_idx, np.int64),
                test_idx=np.asarray(te_idx, np.int64),
                num_nodes=n, num_relations=2 * len(rels),
                num_classes=len(classes))
