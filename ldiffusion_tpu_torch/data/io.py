"""Image readers and writers, and dataset file lists (the port's copy of
``ldiffusion_tpu/data/io.py:24-363``; reference ``imageio/*`` and
``utilities/utils.py:51-66``).

A reader/writer is chosen from the dataset's file ending, or by name from
dataset.json's ``overwrite_image_reader_writer``. Images come back
(c, *spatial) float32 with their spacing (z, y, x) in the properties; labels
are written uint8. ``NaturalImage2DIO`` (PIL) reads PNG/BMP/TIF/JPEG as
(c, 1, X, Y) with the spacing (999, 1, 1). ``NumpyIO`` reads ``.npy`` volumes
(Z, H, W), one file a channel, with a ``<name>.json`` ``{"spacing": [...]}``
sidecar (unit spacing without one), the JAX package's convention. NIfTI
(``NibabelIO``, ``NibabelIOWithReorient``), SimpleITK's formats
(``SimpleITKIO``) and 3D TIFF stacks (``Tiff3DIO``) import their package when
the reader is made and raise ``ImportError`` naming it when it is missing;
``determine_reader_writer`` then raises naming every reader it could not
make.

Channel files ``<case>_NNNN<ending>`` are grouped per case, and the training
split comes from the ``"dataset"`` dict of dataset.json when it has one
(relative paths against the dataset directory), else from imagesTr/labelsTr.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

NATURAL_2D_SPACING = (999.0, 1.0, 1.0)


def _sidecar_spacing(path: str):
    """The ``spacing`` of ``<name>.json`` beside ``path``, else unit."""
    sidecar = os.path.splitext(path)[0] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return list(json.load(f).get("spacing", (1.0, 1.0, 1.0)))
    return [1.0, 1.0, 1.0]


def _write_sidecar(path: str, properties) -> None:
    if properties and "spacing" in properties:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump({"spacing": list(properties["spacing"])}, f)


def _stack_volumes(vols, reader: str):
    for v in vols:
        if v.ndim != 3:
            raise ValueError(f"{reader} expects (Z, H, W) arrays, got {v.shape}")
    return np.stack(vols)


class BaseReaderWriter:
    """Interface (reference ``imageio/base_reader_writer.py``)."""

    supported_endings: Tuple[str, ...] = ()

    def read_images(self, paths) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def read_seg(self, path) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def write_seg(self, seg: np.ndarray, path: str, properties: Optional[Dict] = None):
        raise NotImplementedError


class NaturalImage2DIO(BaseReaderWriter):
    """PNG/BMP/TIF/JPEG (reference ``natural_image_reader_writer.py:22-65``)."""

    supported_endings = (".png", ".bmp", ".tif", ".tiff", ".jpg", ".jpeg")

    def read_images(self, paths):
        from PIL import Image

        stacks = []
        for p in paths:
            with Image.open(p) as im:
                arr = np.asarray(im).astype(np.float32)
            arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)  # (c, X, Y)
            stacks.append(arr[:, None])
        return np.vstack(stacks), {"spacing": list(NATURAL_2D_SPACING)}

    def read_seg(self, path):
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("L"), np.uint8)
        return arr[None, None].astype(np.float32), {"spacing": list(NATURAL_2D_SPACING)}

    def write_seg(self, seg, path, properties=None):
        from PIL import Image

        Image.fromarray(np.squeeze(seg).astype(np.uint8)).save(path)


class NibabelIO(BaseReaderWriter):
    """NIfTI through nibabel (reference ``nibabel_reader_writer.py``): arrays
    transposed to (z, y, x), the zooms reversed, the affine kept for writing."""

    supported_endings = (".nii", ".nii.gz")

    def __init__(self):
        import nibabel  # ImportError naming nibabel when it is missing

        self._nib = nibabel

    def read_images(self, paths):
        imgs = [self._nib.load(p) for p in paths]
        data = np.stack([np.asanyarray(i.dataobj).astype(np.float32).T for i in imgs])
        return data, {"spacing": list(imgs[0].header.get_zooms()[::-1]),
                      "affine": imgs[0].affine.tolist()}

    def read_seg(self, path):
        img = self._nib.load(path)
        return (np.asanyarray(img.dataobj).astype(np.float32).T[None],
                {"spacing": list(img.header.get_zooms()[::-1])})

    def write_seg(self, seg, path, properties=None):
        affine = np.asarray(properties["affine"]) if properties and "affine" in properties \
            else np.eye(4)
        self._nib.save(self._nib.Nifti1Image(np.squeeze(seg).T.astype(np.uint8), affine),
                       path)


class NibabelIOWithReorient(BaseReaderWriter):
    """NIfTI through nibabel, reoriented to RAS on reading and back to the
    original affine on writing (reference ``nibabel_reader_writer.py:100-184``)."""

    supported_endings = (".nii", ".nii.gz")

    def __init__(self):
        import nibabel  # ImportError naming nibabel when it is missing

        self._nib = nibabel

    def read_images(self, paths):
        from nibabel.orientations import io_orientation

        arrays, original_affine, reoriented_affine, spacing = [], None, None, None
        for p in paths:
            img = self._nib.load(p)
            reoriented = img.as_reoriented(io_orientation(img.affine))
            if original_affine is None:
                original_affine = img.affine
                reoriented_affine = reoriented.affine
                spacing = [float(z) for z in reoriented.header.get_zooms()[::-1]]
            arrays.append(reoriented.get_fdata().transpose(2, 1, 0))
        return (np.stack(arrays).astype(np.float32),
                {"spacing": spacing,
                 "nibabel_stuff": {"original_affine": original_affine.tolist(),
                                   "reoriented_affine": reoriented_affine.tolist()}})

    def read_seg(self, path):
        return self.read_images([path])

    def write_seg(self, seg, path, properties=None):
        from nibabel.orientations import io_orientation

        if not (properties and "nibabel_stuff" in properties):
            raise ValueError("NibabelIOWithReorient.write_seg needs the read-side affines")
        original = np.asarray(properties["nibabel_stuff"]["original_affine"])
        reoriented = np.asarray(properties["nibabel_stuff"]["reoriented_affine"])
        seg_img = self._nib.Nifti1Image(np.squeeze(seg).transpose(2, 1, 0).astype(np.uint8),
                                        reoriented)
        restored = seg_img.as_reoriented(io_orientation(original))
        if not np.allclose(original, restored.affine):
            raise ValueError("restored affine does not match the original affine")
        self._nib.save(restored, path)


class SimpleITKIO(BaseReaderWriter):
    """SimpleITK's formats (reference ``simpleitk_reader_writer.py``): arrays
    (c, Z, H, W), ITK's (x, y, z) spacing reversed; labels written with the
    spacing, origin and direction of the properties."""

    supported_endings = (".mha", ".mhd", ".nrrd", ".gz", ".nii", ".nii.gz")

    def __init__(self):
        import SimpleITK  # ImportError naming SimpleITK when it is missing

        self._sitk = SimpleITK

    def read_images(self, paths):
        sitk = self._sitk
        arrays, props = [], None
        for p in paths:
            img = sitk.ReadImage(p)
            arrays.append(sitk.GetArrayFromImage(img).astype(np.float32))
            if props is None:
                props = {"spacing": list(img.GetSpacing())[::-1],
                         "origin": list(img.GetOrigin()),
                         "direction": list(img.GetDirection())}
        data = np.stack(arrays)
        return (data[:, None] if data.ndim == 3 else data), props

    def read_seg(self, path):
        return self.read_images([path])

    def write_seg(self, seg, path, properties=None):
        sitk = self._sitk
        img = sitk.GetImageFromArray(np.squeeze(seg).astype(np.uint8))
        if properties:
            if "spacing" in properties:
                img.SetSpacing(tuple(properties["spacing"][::-1]))
            if "origin" in properties:
                img.SetOrigin(tuple(properties["origin"]))
            if "direction" in properties:
                img.SetDirection(tuple(properties["direction"]))
        sitk.WriteImage(img, path)


class Tiff3DIO(BaseReaderWriter):
    """3D multipage TIFF through tifffile (reference ``tif_reader_writer.py``),
    the spacing from the ``<name>.json`` sidecar."""

    supported_endings = (".tif", ".tiff")

    def __init__(self):
        import tifffile  # ImportError naming tifffile when it is missing

        self._tiff = tifffile

    def read_images(self, paths):
        vols = [self._tiff.imread(p).astype(np.float32) for p in paths]
        return _stack_volumes(vols, "Tiff3DIO"), {"spacing": _sidecar_spacing(paths[0])}

    def read_seg(self, path):
        return (self._tiff.imread(path).astype(np.float32)[None],
                {"spacing": _sidecar_spacing(path)})

    def write_seg(self, seg, path, properties=None):
        self._tiff.imwrite(path, np.squeeze(seg).astype(np.uint8))
        _write_sidecar(path, properties)


class NumpyIO(BaseReaderWriter):
    """``.npy`` volumes (Z, H, W) with the ``<name>.json`` spacing sidecar."""

    supported_endings = (".npy",)

    def read_images(self, paths):
        vols = [np.load(p).astype(np.float32) for p in paths]
        return _stack_volumes(vols, "NumpyIO"), {"spacing": _sidecar_spacing(paths[0])}

    def read_seg(self, path):
        return np.load(path).astype(np.float32)[None], {"spacing": _sidecar_spacing(path)}

    def write_seg(self, seg, path, properties=None):
        np.save(path, np.squeeze(seg).astype(np.uint8))
        _write_sidecar(path, properties)


# the order is the priority: the 2D reader claims .tif first (reference
# ``reader_writer_registry.py``); 3D TIFF stacks name Tiff3DIO in dataset.json
_REGISTRY = [NaturalImage2DIO, NibabelIO, NibabelIOWithReorient, SimpleITKIO,
             Tiff3DIO, NumpyIO]
_BY_NAME = {cls.__name__: cls for cls in _REGISTRY}


def determine_reader_writer(file_ending: str) -> BaseReaderWriter:
    """The first reader of the ending that can be made; raises ``ValueError``
    naming the readers whose package is missing."""
    ending = file_ending.lower()
    errors = []
    for cls in _REGISTRY:
        if any(ending.endswith(e) for e in cls.supported_endings):
            try:
                return cls()
            except ImportError as e:
                errors.append(f"{cls.__name__}: {e}")
    raise ValueError(f"no reader/writer for '{file_ending}'"
                     + (f" (unavailable: {errors})" if errors else ""))


def determine_reader_writer_from_dataset_json(dataset_json: Dict) -> BaseReaderWriter:
    """``overwrite_image_reader_writer`` by name, else by ``file_ending``
    (reference ``reader_writer_registry.py:20-40``)."""
    name = dataset_json.get("overwrite_image_reader_writer")
    if name and name in _BY_NAME:
        return _BY_NAME[name]()
    return determine_reader_writer(dataset_json.get("file_ending", ".png"))


def group_channel_files(img_dir: str, ending: str) -> Dict[str, list]:
    """case id → its file names; a name without a 4-digit channel suffix is
    a case of its own."""
    groups: Dict[str, list] = {}
    for fn in sorted(os.listdir(img_dir)):
        if not fn.lower().endswith(ending):
            continue
        stem = fn[: -len(ending)]
        case, _, ch = stem.rpartition("_")
        key = case if (case and ch.isdigit() and len(ch) == 4) else stem
        groups.setdefault(key, []).append(fn)
    return groups


def get_train_images_and_targets(ds_dir: str,
                                 dataset_json: Optional[Dict] = None) -> Dict[str, Dict]:
    """case id → {"images": [absolute paths], "label": absolute path}."""
    if dataset_json is None:
        with open(os.path.join(ds_dir, "dataset.json")) as f:
            dataset_json = json.load(f)

    def resolve(p):
        return p if os.path.isabs(p) else os.path.abspath(os.path.join(ds_dir, p))

    if "dataset" in dataset_json:
        return {case: {"images": [resolve(i) for i in entry["images"]],
                       "label": resolve(entry["label"])}
                for case, entry in dataset_json["dataset"].items()}
    ending = dataset_json.get("file_ending", ".png").lower()
    img_dir = os.path.join(ds_dir, "imagesTr")
    lbl_dir = os.path.join(ds_dir, "labelsTr")
    groups = group_channel_files(img_dir, ending) if os.path.isdir(img_dir) else {}
    return {case: {"images": [os.path.join(img_dir, f) for f in files],
                   "label": os.path.join(lbl_dir, case + ending)}
            for case, files in groups.items()}
