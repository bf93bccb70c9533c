"""ARFF-style text IO -- the paper's DataStreamLoader/Writer (§3.1)
(counterpart of ``repro.data.io``).

A minimal Weka-ARFF subset: ``@relation``, ``@attribute <name> REAL`` or
``@attribute <name> {v0,v1,...}``, ``@data`` CSV rows.  Dynamic streams use
the paper's convention of leading SEQUENCE_ID / TIME_ID REAL columns.
Numpy only: the files are the JAX package's, byte for byte.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.stream import (Attribute, DataStream, DynamicDataStream,
                                     FINITE, REAL)


def load_arff(path: str) -> DataStream:
    attrs: List[Attribute] = []
    rows: List[List[str]] = []
    in_data = False
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if low.startswith("@relation"):
                continue
            if low.startswith("@attribute"):
                _, name, kind = line.split(None, 2)
                kind = kind.strip()
                if kind.upper() in ("REAL", "NUMERIC"):
                    attrs.append(Attribute(name, REAL))
                elif kind.startswith("{"):
                    vals = [v.strip() for v in kind.strip("{}").split(",")]
                    attrs.append(Attribute(name, FINITE, len(vals)))
                else:
                    raise ValueError(f"unsupported attribute type {kind!r}")
                continue
            if low.startswith("@data"):
                in_data = True
                continue
            if in_data:
                rows.append(line.split(","))
    cont_idx = [i for i, a in enumerate(attrs) if a.kind == REAL]
    disc_idx = [i for i, a in enumerate(attrs) if a.kind == FINITE]
    n = len(rows)
    xc = np.zeros((n, len(cont_idx)), np.float32)
    xd = np.zeros((n, len(disc_idx)), np.int32)
    for r, row in enumerate(rows):
        for j, i in enumerate(cont_idx):
            xc[r, j] = float(row[i])
        for j, i in enumerate(disc_idx):
            xd[r, j] = int(float(row[i]))
    return DataStream.from_arrays(attrs, xc, xd)


def save_arff(path: str, stream: DataStream, relation: str = "repro") -> None:
    batch = stream.collect()
    with open(path, "w") as f:
        f.write(f"@relation {relation}\n\n")
        for a in stream.attributes:
            if a.kind == REAL:
                f.write(f"@attribute {a.name} REAL\n")
            else:
                vals = ",".join(str(v) for v in range(a.card))
                f.write(f"@attribute {a.name} {{{vals}}}\n")
        f.write("\n@data\n")
        xc = np.asarray(batch.xc)
        xd = np.asarray(batch.xd)
        col_kind = [a.kind for a in stream.attributes]
        for r in range(xc.shape[0]):
            parts = []
            ci = di = 0
            for kind in col_kind:
                if kind == REAL:
                    parts.append(repr(float(xc[r, ci])))
                    ci += 1
                else:
                    parts.append(str(int(xd[r, di])))
                    di += 1
            f.write(",".join(parts) + "\n")


def load_dynamic_arff(path: str) -> DynamicDataStream:
    """Paper §3.1 dynamic format: SEQUENCE_ID, TIME_ID leading columns.

    As in the JAX package, the first two REAL columns must be SEQUENCE_ID
    and TIME_ID (FINITE columns before them are allowed), and FINITE
    attributes stay in the attribute list while their values are dropped."""
    flat = load_arff(path)
    xc = np.asarray(flat.collect().xc)
    names = [a.name for a in flat.attributes if a.kind == REAL]
    if names[:2] != ["SEQUENCE_ID", "TIME_ID"]:
        raise ValueError("dynamic ARFF needs SEQUENCE_ID, TIME_ID columns")
    seq = xc[:, 0].astype(int)
    t = xc[:, 1].astype(int)
    vals = xc[:, 2:]
    S, T = seq.max() + 1, t.max() + 1
    out = np.zeros((S, T, vals.shape[1]), np.float32)
    mask = np.zeros((S, T), np.float32)
    out[seq, t] = vals
    mask[seq, t] = 1.0
    attrs = [a for a in flat.attributes
             if a.name not in ("SEQUENCE_ID", "TIME_ID")]
    return DynamicDataStream(attrs, out, mask=mask)
