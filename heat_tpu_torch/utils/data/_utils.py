"""Standalone data-preparation utilities (reference: heat/utils/data/_utils.py,
a copy of heat_tpu/utils/data/_utils.py, which needs only numpy and h5py).

The reference ships two untested, unsupported helpers for converting ImageNet
TFRecord shards to HDF5 and producing DALI index files (reference
_utils.py:13-45, :47-260). The TPU-native analogs below keep the same names
and contract — byte-offset index files for TFRecord shards (pure stdlib; the
TFRecord wire format is ``{u64 length, u32 crc, payload, u32 crc}``), and a
merge of many record shards into the two big HDF5 files the
``PartialH5Dataset`` loader streams from — without requiring DALI or
TensorFlow.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

__all__ = ["dali_tfrecord2idx", "merge_files_imagenet_tfrecord"]


def _iter_tfrecord_offsets(path: str):
    """Yield (offset, total_record_length) for each record in a TFRecord file."""
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            start = f.tell()
            header = f.read(8)
            if len(header) < 8:
                return
            (proto_len,) = struct.unpack("<Q", header)
            end = start + 8 + 4 + proto_len + 4  # header, crc, payload, crc
            if end > file_size:
                raise ValueError(
                    f"{path}: corrupt or truncated TFRecord at offset {start} "
                    f"(record claims {proto_len} payload bytes, file has {file_size - start - 16})"
                )
            f.seek(end)
            yield start, end - start


def dali_tfrecord2idx(train_dir: str, train_idx_dir: str, val_dir: str, val_idx_dir: str) -> None:
    """Write ``<offset> <length>`` index lines for every TFRecord shard in the
    train/val directories (reference _utils.py:13-45). The index format is the
    one DALI's ``tfrecord2idx`` emits; producing it needs only the framing."""
    for src_dir, idx_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        os.makedirs(idx_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            with open(os.path.join(idx_dir, name), "w") as idx:
                for offset, length in _iter_tfrecord_offsets(src):
                    idx.write(f"{offset} {length}\n")


def merge_files_imagenet_tfrecord(folder_name: str, output_folder: Optional[str] = None) -> None:
    """Merge per-shard ``.npz`` record files (keys ``images``, ``labels``) into
    the two HDF5 files (``imagenet_merged.h5``, ``imagenet_merged_validation.h5``)
    that :class:`~heat_tpu_torch.utils.data.partial_dataset.PartialH5Dataset` streams
    from (reference _utils.py:47-260 does the same from raw TFRecord protos).

    The reference decodes TF protobuf examples; without TensorFlow in the
    image, the supported interchange here is npz shards — any TFRecord set can
    be converted to npz shards offline with the index files from
    :func:`dali_tfrecord2idx`.
    """
    import h5py

    output_folder = output_folder or folder_name
    os.makedirs(output_folder, exist_ok=True)

    def shard_names(prefix: str) -> List[str]:
        return sorted(
            os.path.join(folder_name, f)
            for f in os.listdir(folder_name)
            if f.startswith(prefix) and f.endswith(".npz")
        )

    for prefix, out_name in (
        ("train", "imagenet_merged.h5"),
        ("val", "imagenet_merged_validation.h5"),
    ):
        shards = shard_names(prefix)
        if not shards:
            continue
        out_path = os.path.join(output_folder, out_name)
        with h5py.File(out_path, "w") as out:
            img_ds = lbl_ds = None
            for shard in shards:
                with np.load(shard) as data:
                    images, labels = data["images"], data["labels"]
                if img_ds is None:
                    img_ds = out.create_dataset(
                        "images", shape=(0,) + images.shape[1:], maxshape=(None,) + images.shape[1:],
                        dtype=images.dtype, chunks=True,
                    )
                    lbl_ds = out.create_dataset(
                        "metadata", shape=(0,) + labels.shape[1:], maxshape=(None,) + labels.shape[1:],
                        dtype=labels.dtype, chunks=True,
                    )
                n = img_ds.shape[0]
                img_ds.resize(n + images.shape[0], axis=0)
                lbl_ds.resize(n + labels.shape[0], axis=0)
                img_ds[n:] = images
                lbl_ds[n:] = labels
