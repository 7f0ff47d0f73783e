"""Atomic checkpoint writes: write to `<path>.tmp`, fsync, then
os.replace, which is atomic on POSIX, so a reader sees the old complete
file or the new one and never a torn one (a process killed mid-write
would otherwise leave a truncated .npz that breaks every later resume).
The JAX package's utils/io.py, copied."""
from __future__ import annotations

import os
import pickle

import numpy as np


def atomic_savez(path: str, compressed: bool = False, **arrays) -> None:
    """np.savez(path, **arrays) (or savez_compressed) with tmp+rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_save_npy(path: str, array) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_pickle(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def valid_npz(path: str) -> bool:
    """True if `path` is a loadable npz."""
    try:
        with np.load(path, allow_pickle=False) as z:
            _ = z.files
        return True
    except Exception:
        return False
