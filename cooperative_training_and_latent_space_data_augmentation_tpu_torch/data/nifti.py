"""NIfTI-1/2 (.nii, .nii.gz) and NRRD readers and writers in numpy.

A copy of the JAX package's ``data/nifti.py`` (numpy, ``gzip`` and
``struct``; the port imports nothing of the JAX package).  The reference
reads its volumes through SimpleITK
(medseg/common_utils/basic_operations.py:337-365), which is not needed
here: single-file and header/image-pair NIfTI with raw or gzip encoding,
common dtypes, sform or pixdim spacing and scl_slope/inter rescaling;
NRRD with 'raw' or 'gzip' encoding.  Arrays are returned in C-order
(z, y, x) like SimpleITK's GetArrayFromImage, spacings as (sx, sy, sz).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _maybe_gzip_read(path: str) -> bytes:
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _sform_qform_spacing(e: str, buf: bytes, pixdim) -> Tuple[float, ...]:
    """Voxel spacing with the NIfTI method-priority fallback chain: when
    ``sform_code > 0`` the spacing is the column norms of the srow affine
    (pixdim may be stale/zero in such files); ``qform_code > 0`` or neither
    falls back to pixdim (the qform quaternion is a pure rotation, so its
    spacing IS pixdim).  Zero/negative entries fall back to 1.0 so a sloppy
    header can never produce a zero spacing downstream."""
    sform_code = struct.unpack(e + "h", buf[254:256])[0]
    spacing = [float(p) for p in pixdim[1:4]]
    if sform_code > 0:
        srow = struct.unpack(e + "12f", buf[280:328])  # srow_x, srow_y, srow_z
        m = np.asarray(srow, np.float64).reshape(3, 4)[:, :3]
        norms = np.sqrt((m * m).sum(axis=0))           # column j = voxel axis j
        if np.all(np.isfinite(norms)) and np.all(norms > 0):
            spacing = [float(n) for n in norms]
    return tuple(s if np.isfinite(s) and s > 0 else 1.0 for s in spacing)


def _nifti_data_buffer(path: str, buf: bytes, magic: bytes) -> Tuple[bytes, bool]:
    """Resolve the voxel buffer for single-file ('n+1') vs header/image-pair
    ('ni1') layouts.  Returns (buffer holding voxels, offset_is_in_buffer)."""
    if magic[:3] == b"ni1":
        # two-file NIfTI: voxels live in a sibling .img (vox_offset applies
        # to the .img stream and is typically 0)
        base = path[:-3] if path.endswith(".gz") else path
        root, _ = os.path.splitext(base)
        for cand in (root + ".img", root + ".img.gz"):
            if os.path.exists(cand):
                return _maybe_gzip_read(cand), False
        raise FileNotFoundError(
            f"{path}: header-only NIfTI ('ni1' magic) but no sibling "
            f"{root}.img[.gz] found")
    return buf, True


def read_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read a NIfTI-1/NIfTI-2 volume (single-file or .hdr/.img pair, raw or
    gzipped, either byte order).  Returns (array in (z, y, x) C-order,
    spacing (sx, sy, sz) in ITK convention: x fastest).

    Header handling hardened for real-world ACDC/M&Ms files
    (basic_operations.py:337-365 reads these through SimpleITK):
    scl_slope/scl_inter rescaling (NaN slope treated as 1), sform-affine
    spacing with pixdim fallback, byte-swapped (big-endian) headers, 4-D
    volumes (first timepoint), and clear errors for anything else.
    """
    buf = _maybe_gzip_read(path)
    if len(buf) < 348:
        raise ValueError(f"{path}: too short ({len(buf)} B) for a NIfTI header")
    sizeof_hdr = struct.unpack("<i", buf[0:4])[0]
    endian = "<"
    if sizeof_hdr == 540 or struct.unpack(">i", buf[0:4])[0] == 540:
        return _read_nifti2(path, buf)
    if sizeof_hdr != 348:
        if struct.unpack(">i", buf[0:4])[0] == 348:
            endian = ">"
        else:
            raise ValueError(
                f"{path}: bad sizeof_hdr {sizeof_hdr} — not a NIfTI-1 "
                f"(348) or NIfTI-2 (540) header")
    e = endian
    dim = struct.unpack(e + "8h", buf[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: implausible dim[0]={ndim} "
                         f"(byte-order detection failed?)")
    shape_xyz = [max(1, d) for d in dim[1:1 + max(ndim, 3)]]
    datatype = struct.unpack(e + "h", buf[70:72])[0]
    pixdim = struct.unpack(e + "8f", buf[76:108])
    vox_offset = struct.unpack(e + "f", buf[108:112])[0]
    scl_slope = struct.unpack(e + "f", buf[112:116])[0]
    scl_inter = struct.unpack(e + "f", buf[116:120])[0]
    magic = buf[344:348]
    if datatype not in _NIFTI_DTYPES:
        raise NotImplementedError(
            f"{path}: NIfTI datatype code {datatype} not supported "
            f"(supported: {sorted(_NIFTI_DTYPES)})")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(e)
    data_buf, offset_in_hdr = _nifti_data_buffer(path, buf, magic)
    n_vox = int(np.prod(shape_xyz))
    if offset_in_hdr:
        start = int(vox_offset) if vox_offset >= 348 else 352
    else:
        start = int(vox_offset) if vox_offset > 0 else 0
    need = start + n_vox * dtype.itemsize
    if len(data_buf) < need:
        raise ValueError(
            f"{path}: truncated voxel data — header promises "
            f"{n_vox}x{dtype.itemsize} B at offset {start} "
            f"({need} B total) but only {len(data_buf)} B present")
    data = np.frombuffer(data_buf, dtype=dtype, count=n_vox, offset=start)
    return _finish_nifti(data, shape_xyz, scl_slope, scl_inter,
                         _sform_qform_spacing(e, buf, pixdim))


def _finish_nifti(data: np.ndarray, shape_xyz, scl_slope: float,
                  scl_inter: float, spacing) -> Tuple[np.ndarray, Tuple[float, ...]]:
    # NIfTI data is Fortran-ordered over (x, y, z, ...)
    arr = data.reshape(shape_xyz, order="F")
    if arr.ndim > 3:
        arr = arr.reshape(list(shape_xyz[:3]) + [-1], order="F")[..., 0]
    # (x, y, z) -> (z, y, x)
    arr = np.ascontiguousarray(np.transpose(arr, (2, 1, 0)))
    if not np.isfinite(scl_slope):
        scl_slope = 1.0  # NaN slope: per spec, "no scaling stored"
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * slope + scl_inter
    return arr, spacing


def _read_nifti2(path: str, buf: bytes) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """NIfTI-2 (sizeof_hdr 540): same fields at 64-bit offsets."""
    e = "<" if struct.unpack("<i", buf[0:4])[0] == 540 else ">"
    if len(buf) < 540:
        raise ValueError(f"{path}: too short for a NIfTI-2 header")
    datatype = struct.unpack(e + "h", buf[12:14])[0]
    dim = struct.unpack(e + "8q", buf[16:80])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: implausible NIfTI-2 dim[0]={ndim}")
    shape_xyz = [max(1, int(d)) for d in dim[1:1 + max(ndim, 3)]]
    pixdim = struct.unpack(e + "8d", buf[104:168])
    vox_offset = struct.unpack(e + "q", buf[168:176])[0]
    scl_slope = struct.unpack(e + "d", buf[176:184])[0]
    scl_inter = struct.unpack(e + "d", buf[184:192])[0]
    sform_code = struct.unpack(e + "i", buf[348:352])[0]
    spacing = [float(p) for p in pixdim[1:4]]
    if sform_code > 0:
        srow = struct.unpack(e + "12d", buf[400:496])
        m = np.asarray(srow, np.float64).reshape(3, 4)[:, :3]
        norms = np.sqrt((m * m).sum(axis=0))
        if np.all(np.isfinite(norms)) and np.all(norms > 0):
            spacing = [float(n) for n in norms]
    spacing = tuple(s if np.isfinite(s) and s > 0 else 1.0 for s in spacing)
    if datatype not in _NIFTI_DTYPES:
        raise NotImplementedError(
            f"{path}: NIfTI datatype code {datatype} not supported")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(e)
    n_vox = int(np.prod(shape_xyz))
    start = int(vox_offset) if vox_offset >= 540 else 544
    need = start + n_vox * dtype.itemsize
    if len(buf) < need:
        raise ValueError(f"{path}: truncated NIfTI-2 voxel data "
                         f"({need} B needed, {len(buf)} B present)")
    data = np.frombuffer(buf, dtype=dtype, count=n_vox, offset=start)
    return _finish_nifti(data, shape_xyz, float(scl_slope), float(scl_inter),
                         spacing)


def write_nifti(path: str, array_zyx: np.ndarray,
                spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a minimal NIfTI-1 single file (gzipped when path ends .gz)."""
    arr = np.asarray(array_zyx)
    assert arr.ndim == 3, arr.shape
    if arr.dtype not in _NIFTI_CODES:
        arr = arr.astype(np.float32)
    code = _NIFTI_CODES[np.dtype(arr.dtype)]
    xyz = np.transpose(arr, (2, 1, 0))  # (x, y, z)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, xyz.shape[0], xyz.shape[1], xyz.shape[2],
                     1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)   # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)   # scl_inter
    # sform/qform codes 0 -> rely on pixdim; magic
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + xyz.tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


_NRRD_DTYPES = {
    "float": np.float32, "float32": np.float32, "double": np.float64,
    "int": np.int32, "int32": np.int32, "short": np.int16, "int16": np.int16,
    "uchar": np.uint8, "uint8": np.uint8, "unsigned char": np.uint8,
    "uint16": np.uint16, "unsigned short": np.uint16, "int8": np.int8,
    "long": np.int64, "int64": np.int64,
}


def read_nrrd(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read an NRRD volume (raw/gzip encodings).  Returns (array (z, y, x),
    spacing (sx, sy, sz))."""
    with open(path, "rb") as f:
        blob = f.read()
    header_end = blob.find(b"\n\n")
    if header_end < 0:
        raise ValueError(f"{path}: no NRRD header terminator")
    header_lines = blob[:header_end].decode("ascii", errors="replace").splitlines()
    data = blob[header_end + 2:]
    fields: Dict[str, str] = {}
    for line in header_lines[1:]:
        if line.startswith("#") or ":" not in line:
            continue
        k, v = line.split(":", 1)
        fields[k.strip().lower()] = v.strip().lstrip("=").strip()
    dtype = _NRRD_DTYPES[fields["type"]]
    sizes = [int(s) for s in fields["sizes"].split()]
    encoding = fields.get("encoding", "raw")
    endian = fields.get("endian", "little")
    if encoding in ("gzip", "gz"):
        data = gzip.decompress(data)
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding {encoding}")
    dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
    arr = np.frombuffer(data, dtype=dt, count=int(np.prod(sizes)))
    arr = arr.reshape(sizes, order="F")  # NRRD default is x-fastest
    if arr.ndim == 3:
        arr = np.ascontiguousarray(np.transpose(arr, (2, 1, 0)))
    spacing = (1.0, 1.0, 1.0)
    if "space directions" in fields:
        dirs = fields["space directions"].replace("(", " ").replace(")", " ").split()
        try:
            vals = [float(x) for x in ",".join(dirs).replace(",", " ").split()]
            if len(vals) >= 9:
                spacing = (abs(vals[0]), abs(vals[4]), abs(vals[8]))
        except ValueError:
            pass
    elif "spacings" in fields:
        spacing = tuple(float(s) for s in fields["spacings"].split())
    return arr, spacing


def write_nrrd(path: str, array_zyx: np.ndarray,
               spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
               encoding: str = "gzip") -> None:
    arr = np.asarray(array_zyx)
    assert arr.ndim == 3
    type_name = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
                 np.dtype(np.int16): "short", np.dtype(np.int32): "int",
                 np.dtype(np.uint8): "uchar", np.dtype(np.int64): "int64",
                 np.dtype(np.uint16): "uint16"}.get(arr.dtype)
    if type_name is None:
        arr = arr.astype(np.float32)
        type_name = "float"
    xyz = np.transpose(arr, (2, 1, 0))
    header = [
        "NRRD0004",
        f"type: {type_name}",
        "dimension: 3",
        "space: left-posterior-superior",
        f"sizes: {xyz.shape[0]} {xyz.shape[1]} {xyz.shape[2]}",
        f"space directions: ({spacing[0]},0,0) (0,{spacing[1]},0) (0,0,{spacing[2]})",
        "kinds: domain domain domain",
        "endian: little",
        f"encoding: {encoding}",
        "space origin: (0,0,0)",
    ]
    payload = xyz.tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n\n").encode("ascii"))
        f.write(payload)


def load_img_label_from_path(img_path: str, label_path: Optional[str] = None,
                             new_spacing=None, normalize: bool = False):
    """Read an image (+label) volume pair with optional in-plane resampling
    and 2-98 percentile normalization
    (basic_operations.load_img_label_from_path:337-365)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.preprocess import (
        normalize_minmax_data,
        resample_by_spacing,
    )

    reader = read_nrrd if img_path.endswith(".nrrd") else read_nifti
    img, spacing = reader(img_path)
    img = img.astype(np.float32)
    label = None
    if label_path is not None:
        lreader = read_nrrd if label_path.endswith(".nrrd") else read_nifti
        label, _ = lreader(label_path)
    if new_spacing is not None:
        img = resample_by_spacing(img, spacing, new_spacing, order=1)
        if label is not None:
            label = resample_by_spacing(label, spacing, new_spacing, order=0)
        spacing = tuple(
            s if ns is not None and ns <= 0 else float(ns)
            for s, ns in zip(spacing, new_spacing))
    if normalize:
        img = normalize_minmax_data(img)
    return (img, label, spacing)
