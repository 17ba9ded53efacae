"""PLY point-cloud codec (binary little-endian + ASCII), no Open3D. The
counterpart of ``txr/io/ply.py``: the same bytes for the same arrays.

Replaces the reference's Open3D writer (depth_processor.py:424-450,
depth_to_reconstruction.py:673-703) and its manual ASCII fallback
(depth_enhanced_reconstruction.py:1283-1311). Binary layout matches Open3D's
default write_point_cloud output for an XYZ+RGB cloud: little-endian,
x/y/z float32 (Open3D writes double by default — we default to float32 and
offer double for bit-compat), red/green/blue uchar.
"""

from __future__ import annotations

import numpy as np


def _quantize_colors(rgb: np.ndarray) -> np.ndarray:
    """Float colors → uint8, byte-identical to the C++ writer: tolerate
    0..255-scaled floats (divide by 255, like native_write_ply)
    and round half-UP in float32 (the C++ `c*255.0f + 0.5f` truncation —
    np.round's half-to-even differs on exact .5 values)."""
    c = np.asarray(rgb, np.float32)
    if c.size and c.max() > 1.5:
        c = c / np.float32(255.0)
    return np.clip(np.floor(c * np.float32(255.0) + np.float32(0.5)),
                   0, 255).astype(np.uint8)


def write_ply(
    path: str,
    xyz: np.ndarray,
    rgb: np.ndarray | None = None,
    binary: bool = True,
    double_precision: bool = False,
) -> None:
    """Write a point cloud to PLY.

    Args:
      path: output file path.
      xyz: (N, 3) positions.
      rgb: optional (N, 3) colors; floats in [0,1] or uint8 in [0,255].
      binary: binary_little_endian if True, ascii otherwise.
      double_precision: write positions as float64 (Open3D's native layout).
    """
    xyz = np.asarray(xyz)
    n = xyz.shape[0]

    # Hot path: float32 binary emit through the C++ runtime (single-pass
    # interleave; falls through to numpy when no compiler is available).
    if binary and not double_precision and n > 0:
        from txr_torch._native import native_write_ply

        rgb_f = None
        if rgb is not None:
            rgb_f = np.asarray(rgb)
            if rgb_f.dtype == np.uint8:
                rgb_f = rgb_f.astype(np.float32) / 255.0
        if native_write_ply(path, xyz, rgb_f):
            return

    pos_t = np.float64 if double_precision else np.float32
    pos_name = "double" if double_precision else "float"

    has_color = rgb is not None
    if has_color:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = _quantize_colors(rgb)

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {n}")
    header += [f"property {pos_name} x", f"property {pos_name} y", f"property {pos_name} z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    header_bytes = ("\n".join(header) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header_bytes)
        if binary:
            if has_color:
                rec = np.dtype(
                    [("x", pos_t), ("y", pos_t), ("z", pos_t),
                     ("r", np.uint8), ("g", np.uint8), ("b", np.uint8)]
                )
                buf = np.empty(n, dtype=rec)
                buf["x"], buf["y"], buf["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
                buf["r"], buf["g"], buf["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
                f.write(buf.tobytes())
            else:
                f.write(np.ascontiguousarray(xyz, dtype=pos_t).tobytes())
        else:
            if has_color:
                for i in range(n):
                    f.write(
                        (f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f} "
                         f"{rgb[i,0]} {rgb[i,1]} {rgb[i,2]}\n").encode("ascii")
                    )
            else:
                for i in range(n):
                    f.write(f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f}\n".encode("ascii"))


_PLY_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("<i2", 2), "ushort": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def read_ply(path: str):
    """Read a PLY point cloud. Returns (xyz float64 (N,3), rgb float64 (N,3) in
    [0,1] or None). Supports ascii and binary_little_endian vertex elements."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: truncated/malformed file
                raise ValueError(f"{path}: truncated PLY header")
            line = raw.strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))

        if n is None:
            raise ValueError(f"{path}: no vertex element")
        names = [p[1] for p in props]
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            data = {name: rows[:, i] for i, name in enumerate(names)}
        elif fmt == "binary_little_endian":
            rec = np.dtype([(name, _PLY_TYPES[t][0]) for t, name in props])
            raw = np.frombuffer(f.read(rec.itemsize * n), dtype=rec, count=n)
            data = {name: raw[name].astype(np.float64) for name in names}
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

    xyz = np.stack([data["x"], data["y"], data["z"]], axis=-1)
    rgb = None
    if all(k in data for k in ("red", "green", "blue")):
        rgb = np.stack([data["red"], data["green"], data["blue"]], axis=-1) / 255.0
    return xyz, rgb


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
              binary: bool = True) -> None:
    """Write a PCL .pcd file (reference PointCloudGenerator.save_pcd parity,
    depth_processor.py:424-450). Fields x y z [rgb packed-float]."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    has_color = rgb is not None
    if has_color:
        c = np.asarray(rgb)
        if c.dtype != np.uint8:
            c = _quantize_colors(c)
        packed = ((c[:, 0].astype(np.uint32) << 16)
                  | (c[:, 1].astype(np.uint32) << 8)
                  | c[:, 2].astype(np.uint32)).view(np.float32)

    fields = "x y z rgb" if has_color else "x y z"
    sizes = "4 4 4 4" if has_color else "4 4 4"
    types = "F F F F" if has_color else "F F F"
    counts = "1 1 1 1" if has_color else "1 1 1"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            if has_color:
                rec = np.empty((n, 4), np.float32)
                rec[:, :3] = xyz
                rec[:, 3] = packed
                f.write(rec.tobytes())
            else:
                f.write(np.ascontiguousarray(xyz).tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f}"
                if has_color:
                    # Packed-rgb floats live in the denormal range; emit full
                    # precision so parsers round-trip the bit pattern.
                    row += f" {packed[i]:.8e}"
                f.write((row + "\n").encode("ascii"))
