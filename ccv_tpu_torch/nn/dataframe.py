"""Columnar data pipeline of the port (counterpart of
ccv_tpu/nn/dataframe.py; reference: lib/nnc/ccv_cnnp_dataframe*.c).

The reference's dataframe is a lazy column store: derived columns are
computed by map functions on demand, iterators prefetch batches onto a
stream, add-ons provide image loading / random jitter / one-hot / batching /
copy-to-GPU. The port keeps ``ccv_tpu``'s surface and its host numpy (the
same rows, in the same order, from the same seeds: shuffles, samples and
jitters draw from seeded numpy ``Generator``s):

- ``Dataframe.from_array`` / ``from_csv``      (dataframe_addons.c:18, _csv.c)
- ``df.map(col, fn)``                          derived columns, lazy + cached
- ``df.shuffle()``                             (dataframe.c shuffle)
- ``df.batch(n)``                              combine rows into arrays
- ``df.one_hot(col, n)``, ``df.read_image``, ``df.random_jitter``
- ``df.iter(prefetch=k)``                      background-thread prefetch; each
                                               batch goes to ``device`` (default:
                                               the card) from pinned memory,
                                               without waiting (copy-to-GPU twin)
"""

from __future__ import annotations

import csv as _csv
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ccv_tpu_torch import device as _device


class _CsvColumn:
    """Lazy column view into the CSV file buffer: (start, end) byte
    offsets per row, decoded only on access (the reference's char*
    pointers into the mmapped chunk, dataframe_csv.c)."""

    __slots__ = ("_data", "_starts", "_ends")

    def __init__(self, data: bytes, starts: np.ndarray, ends: np.ndarray):
        self._data = data
        self._starts = starts
        self._ends = ends

    def __len__(self):
        return len(self._starts)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return self._data[int(self._starts[i]):int(self._ends[i])].decode()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def numeric(self, dtype=np.float32) -> np.ndarray:
        """Whole-column numeric parse in one numpy pass."""
        return np.array([self[i] for i in range(len(self))], dtype=dtype)


class Dataframe:
    def __init__(self, columns: Dict[str, Any], n: int):
        self._columns = dict(columns)   # name -> list | ndarray | (fn, src)
        self._derived: Dict[str, tuple] = {}
        self._cache: Dict[tuple, Any] = {}
        self._order = np.arange(n)
        self.n = n

    @property
    def columns(self):
        """All column names (ccv_cnnp_dataframe_column_name twin)."""
        return list(self._columns) + list(self._derived)

    def col(self, name: str):
        """The raw column object (list / ndarray / lazy _CsvColumn)."""
        return self._columns[name]

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_array(cls, name: str, array) -> "Dataframe":
        return cls({name: array}, len(array))

    @classmethod
    def from_arrays(cls, **arrays) -> "Dataframe":
        ns = {len(v) for v in arrays.values()}
        assert len(ns) == 1, "columns must share length"
        return cls(arrays, ns.pop())

    @classmethod
    def from_csv(cls, path: str, header: bool = True,
                 delim: str = ",") -> "Dataframe":
        """ccv_cnnp_dataframe_from_csv_new twin (dataframe_csv.c:531).

        The reference parses in two passes over parallel file chunks and
        hands out char* pointers into the buffer rather than copying
        fields. This mirrors that shape: pass 1 locates every row/field
        boundary with vectorized byte scans (chunked across a thread pool
        — numpy releases the GIL), pass 2 is LAZY — columns are
        offset-views into the one file buffer that decode a field only
        when a row is actually read. Files containing double quotes fall
        back to the stdlib csv state machine (the reference's
        double_quotes mode)."""
        with open(path, "rb") as f:
            data = f.read()
        if not data:
            return cls({}, 0)
        if b'"' in data:
            # quoted fields can hide delimiters/newlines: use the real
            # state machine (rare for ML manifests, which is the hot path)
            with open(path, newline="") as f:
                rows = list(_csv.reader(f, delimiter=delim))
            if not rows:
                return cls({}, 0)
            if header:
                names, rows = rows[0], rows[1:]
            else:
                names = [str(i) for i in range(len(rows[0]))]
            cols = {nm: [r[i] if i < len(r) else "" for r in rows]
                    for i, nm in enumerate(names)}
            return cls(cols, len(rows))

        if not data.endswith(b"\n"):
            data += b"\n"
        arr = np.frombuffer(data, np.uint8)

        # pass 1: structure. Chunked flatnonzero across threads (the
        # reference's parallel first pass, dataframe_csv.c:531).
        from concurrent.futures import ThreadPoolExecutor

        nt = min(8, max(1, len(arr) // (1 << 20)))
        bounds = np.linspace(0, len(arr), nt + 1).astype(np.int64)

        def scan(i):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            seg = arr[lo:hi]
            return (np.flatnonzero(seg == 0x0A) + lo,
                    np.flatnonzero(seg == ord(delim)) + lo)

        if nt > 1:
            with ThreadPoolExecutor(nt) as ex:
                parts = list(ex.map(scan, range(nt)))
            nl = np.concatenate([p[0] for p in parts])
            dl = np.concatenate([p[1] for p in parts])
        else:
            nl, dl = scan(0)

        row_start = np.concatenate([[0], nl[:-1] + 1])
        # \r\n: trim the trailing CR from the last field of each row
        row_end = np.where((nl > 0) & (arr[np.maximum(nl - 1, 0)] == 0x0D),
                           nl - 1, nl)
        per_row = np.diff(np.searchsorted(dl, nl), prepend=0)
        ncols = int(per_row[0]) + 1
        if not (per_row == ncols - 1).all():
            # ragged rows: fall back to the state machine
            with open(path, newline="") as f:
                rows = list(_csv.reader(f, delimiter=delim))
            if header:
                names, rows = rows[0], rows[1:]
            else:
                names = [str(i) for i in range(len(rows[0]))]
            cols = {nm: [r[i] if i < len(r) else "" for r in rows]
                    for i, nm in enumerate(names)}
            return cls(cols, len(rows))

        nrows = len(nl)
        if ncols > 1:
            dm = dl.reshape(nrows, ncols - 1)
            starts = np.concatenate([row_start[:, None], dm + 1], axis=1)
            ends = np.concatenate([dm, row_end[:, None]], axis=1)
        else:
            starts = row_start[:, None]
            ends = row_end[:, None]

        first = header
        if header:
            names = [data[int(s):int(e)].decode()
                     for s, e in zip(starts[0], ends[0])]
            starts, ends, nrows = starts[1:], ends[1:], nrows - 1
        else:
            names = [str(i) for i in range(ncols)]
        cols = {nm: _CsvColumn(data, starts[:, j], ends[:, j])
                for j, nm in enumerate(names)}
        return cls(cols, nrows)

    # -- transforms ----------------------------------------------------------
    def map(self, name: str, fn: Callable, src: Sequence[str]) -> "Dataframe":
        """Derive a new column: fn(*src values) per row (dataframe.c:110)."""
        self._derived[name] = (fn, tuple(src))
        return self

    def one_hot(self, name: str, src: str, classes: int,
                dtype=np.float32) -> "Dataframe":
        def fn(v):
            out = np.zeros(classes, dtype)
            out[int(v)] = 1
            return out

        return self.map(name, fn, [src])

    def read_image(self, name: str, src: str, gray: bool = False) -> "Dataframe":
        from ccv_tpu_torch.core.io import IO_GRAY, IO_RGB_COLOR, read

        def fn(path):
            return read(path, IO_GRAY if gray else IO_RGB_COLOR,
                        device="cpu").numpy()

        return self.map(name, fn, [src])

    def random_jitter(self, name: str, src: str, size: int,
                      brightness: float = 0.0, contrast: float = 0.0,
                      saturation: float = 0.0, seed: int = 0) -> "Dataframe":
        """ccv_cnnp_dataframe_image_random_jitter twin (random crop + color
        jitter, host-side numpy to keep the device path deterministic)."""
        rng = np.random.default_rng(seed)

        def fn(img):
            h, w = img.shape[0], img.shape[1]
            if h > size and w > size:
                y = rng.integers(0, h - size)
                x = rng.integers(0, w - size)
                img = img[y:y + size, x:x + size]
            out = img.astype(np.float32)
            if brightness:
                out = out + rng.uniform(-brightness, brightness) * 255
            if contrast:
                c = 1 + rng.uniform(-contrast, contrast)
                out = (out - out.mean()) * c + out.mean()
            if saturation and out.ndim == 3:
                gs = out @ np.array([0.299, 0.587, 0.114], np.float32)
                s = 1 + rng.uniform(-saturation, saturation)
                out = (out - gs[..., None]) * s + gs[..., None]
            return np.clip(out, 0, 255)

        return self.map(name, fn, [src])

    def shuffle(self, seed: Optional[int] = None) -> "Dataframe":
        rng = np.random.default_rng(seed)
        self._order = rng.permutation(self.n)
        self._cache.clear()
        return self

    # -- access ---------------------------------------------------------------
    def _row(self, name: str, i: int):
        key = (name, i)
        if key in self._cache:
            return self._cache[key]
        if name in self._columns:
            val = self._columns[name][i]
        else:
            fn, src = self._derived[name]
            val = fn(*(self._row(s, i) for s in src))
            self._cache[key] = val
        return val

    def row(self, i: int, columns: Sequence[str]):
        j = int(self._order[i])
        return tuple(self._row(c, j) for c in columns)

    def batch(self, columns: Sequence[str], batch_size: int,
              drop_remainder: bool = True, num_threads: int = 0):
        """Yield batches as stacked numpy arrays (batching add-on).

        num_threads > 1 materializes the rows of each batch on a thread
        pool — the analog of the reference's per-column stream contexts
        (dataframe.c:110-189); image decode and numpy jitter release the
        GIL, so IO-heavy derived columns overlap."""
        nb = self.n // batch_size if drop_remainder else -(-self.n // batch_size)
        pool = None
        if num_threads and num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(num_threads)
        try:
            for b in range(nb):
                idxs = range(b * batch_size,
                             b * batch_size
                             + min(batch_size, self.n - b * batch_size))
                if pool is not None:
                    rows = list(pool.map(
                        lambda i: self.row(i, columns), idxs))
                else:
                    rows = [self.row(i, columns) for i in idxs]
                yield tuple(np.stack([r[c] for r in rows])
                            for c in range(len(columns)))
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def iter(self, columns: Sequence[str], batch_size: int,
             prefetch: int = 2, device_put: bool = True,
             num_threads: int = 0, device: _device.DeviceLike = None):
        """Prefetching iterator (ccv_cnnp_dataframe_iter_prefetch twin): a
        background thread assembles batches and, with ``device_put``, copies
        each to ``device`` (default: the card; raises without one) from
        pinned memory without waiting (``device.to_device``), so with
        ``prefetch >= 2`` the next batch's assembly and copy overlap the
        current step. Without ``device_put`` the batches stay numpy."""
        dev = _device.resolve(device) if device_put else None
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()

        def producer():
            try:
                for batch in self.batch(columns, batch_size,
                                        num_threads=num_threads):
                    if dev is not None:
                        batch = tuple(_device.to_device(b, dev)
                                      for b in batch)
                    q.put(batch)
            except BaseException as e:  # handed to the consumer
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    # -- remaining add-ons (ccv_cnnp_dataframe_addons.c / _core.c) ----------
    def one_squared(self, name: str, src: str, max_length: int,
                    fill: float = 0.0) -> "Dataframe":
        """ccv_cnnp_dataframe_one_squared twin: pad/truncate 1-D sequences
        to a fixed length (the NLP batching helper)."""
        def fn(v):
            v = np.atleast_1d(np.asarray(v))
            out = np.full(max_length, fill, v.dtype)
            out[:min(len(v), max_length)] = v[:max_length]
            return out

        return self.map(name, fn, [src])

    def copy_scalar(self, name: str, value) -> "Dataframe":
        """ccv_cnnp_dataframe_copy_scalar twin: a constant column."""
        self._derived[name] = (lambda: value, [])
        return self

    def sample(self, size: int, seed: Optional[int] = None) -> "Dataframe":
        """ccv_cnnp_dataframe_sample_new twin: random subset view."""
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.n, size=min(size, self.n), replace=False)
        out = Dataframe(dict(self._columns), self.n)
        out._derived = dict(self._derived)
        out._order = self._order[np.sort(idx)]
        out.n = len(out._order)
        return out

    def truncate(self, size: int) -> "Dataframe":
        """ccv_cnnp_dataframe_truncate twin: first `size` rows view."""
        out = Dataframe(dict(self._columns), self.n)
        out._derived = dict(self._derived)
        out._order = self._order[:size]
        out.n = len(out._order)
        return out

    def combine(self, other: "Dataframe") -> "Dataframe":
        """ccv_cnnp_dataframe_combine_new twin: row-wise concatenation of
        two dataframes with the same columns."""
        cols = {}
        for name in self._columns:
            a = [self._row(name, int(i)) for i in self._order]
            b = [other._row(name, int(i)) for i in other._order]
            cols[name] = list(a) + list(b)
        return Dataframe(cols, self.n + other.n)

    def make_tuple(self, name: str, srcs: Sequence[str]) -> "Dataframe":
        """ccv_cnnp_dataframe_make_tuple twin."""
        return self.map(name, lambda *vals: tuple(vals), list(srcs))

    def extract_tuple(self, name: str, src: str, index: int) -> "Dataframe":
        """ccv_cnnp_dataframe_extract_tuple twin."""
        return self.map(name, lambda t: t[index], [src])
