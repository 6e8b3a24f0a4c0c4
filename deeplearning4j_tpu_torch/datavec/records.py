"""Record readers — org/datavec/api/records/reader/impl/** parity (the
port's copy of deeplearning4j_tpu/datavec/records.py).

A record is a plain list of values (strings/floats/np arrays); a sequence
record is a list of records. Readers are iterators with reset(), mirroring
RecordReader.next()/hasNext()/reset() without the JVM Writable hierarchy.

Reference classes mirrored (path-cite, mount empty this round):
- CSVRecordReader / CSVSequenceRecordReader  (csv/CSVRecordReader.java)
- LineRecordReader                           (misc/LineRecordReader.java)
- CollectionRecordReader                     (collection/CollectionRecordReader.java)
- RegexLineRecordReader                      (regex/RegexLineRecordReader.java)
- SVMLightRecordReader                       (misc/SVMLightRecordReader.java)
- ImageRecordReader                          (datavec-data-image; PIL replaces
                                              the JavaCPP OpenCV NativeImageLoader)
- TransformProcessRecordReader               (transform wrapper)
"""

from __future__ import annotations

import csv
import os
import re
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np


class RecordReader:
    """Iterator protocol + reset (RecordReader.java parity)."""

    def __iter__(self):
        self.reset()
        return self._gen()

    def _gen(self):
        raise NotImplementedError

    def reset(self):
        pass

    def next_record(self):
        if not hasattr(self, "_it") or self._it is None:
            self._it = iter(self)
        try:
            return next(self._it)
        except StopIteration:
            self._it = None
            raise

    def has_next(self) -> bool:
        if not hasattr(self, "_it") or self._it is None:
            self._it = iter(self)
        try:
            self._peek = next(self._it)
        except StopIteration:
            self._it = None
            return False
        # re-chain the peeked element
        import itertools

        self._it = itertools.chain([self._peek], self._it)
        return True


class LineRecordReader(RecordReader):
    """One record per line: [line]."""

    def __init__(self, path: str, skip_lines: int = 0):
        self.path = path
        self.skip_lines = skip_lines

    def _gen(self):
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """One record per CSV row; values kept as strings (schema/transform or the
    iterator layer handles typing), matching CSVRecordReader's Text writables.

    ``path`` is one file, as in the reference, or (the port's addition, the
    reference's FileSplit over several files) a list of files read one
    after another, ``skip_lines`` skipped in each."""

    def __init__(self, path, skip_lines: int = 0, delimiter: str = ",",
                 quote: str = '"'):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.quote = quote

    def _gen(self):
        paths = ([self.path] if isinstance(self.path, (str, os.PathLike))
                 else list(self.path))
        for path in paths:
            with open(path, newline="") as f:
                rd = csv.reader(f, delimiter=self.delimiter,
                                quotechar=self.quote)
                for i, row in enumerate(rd):
                    if i < self.skip_lines or not row:
                        continue
                    yield list(row)


class CSVSequenceRecordReader(RecordReader):
    """One file = one sequence (list of rows). ``paths`` is a list of files or
    a directory (sorted listing), matching CSVSequenceRecordReader semantics."""

    def __init__(self, paths, skip_lines: int = 0, delimiter: str = ","):
        if isinstance(paths, str) and os.path.isdir(paths):
            paths = [
                os.path.join(paths, p) for p in sorted(os.listdir(paths))
            ]
        self.paths = list(paths) if not isinstance(paths, str) else [paths]
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _gen(self):
        for p in self.paths:
            rows = []
            with open(p, newline="") as f:
                rd = csv.reader(f, delimiter=self.delimiter)
                for i, row in enumerate(rd):
                    if i < self.skip_lines or not row:
                        continue
                    rows.append(list(row))
            yield rows


class CollectionRecordReader(RecordReader):
    """Wraps an in-memory collection of records."""

    def __init__(self, records: Iterable[Sequence[Any]]):
        self.records = [list(r) for r in records]

    def _gen(self):
        yield from (list(r) for r in self.records)


class RegexLineRecordReader(RecordReader):
    """Splits each line by a regex with groups → one value per group."""

    def __init__(self, path: str, regex: str, skip_lines: int = 0):
        self.path = path
        self.pattern = re.compile(regex)
        self.skip_lines = skip_lines

    def _gen(self):
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                m = self.pattern.match(line.rstrip("\n"))
                if m is None:
                    raise ValueError(f"line {i} does not match: {line!r}")
                yield list(m.groups())


class SVMLightRecordReader(RecordReader):
    """`label idx:val idx:val ...` sparse format → [dense features…, label]."""

    def __init__(self, path: str, num_features: int, zero_based: bool = False):
        self.path = path
        self.num_features = num_features
        self.zero_based = zero_based

    def _gen(self):
        with open(self.path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                parts = line.split()
                label = float(parts[0])
                feats = np.zeros(self.num_features, dtype=np.float32)
                for tok in parts[1:]:
                    idx, val = tok.split(":")
                    j = int(idx) - (0 if self.zero_based else 1)
                    feats[j] = float(val)
                yield [*feats.tolist(), label]


class ImageRecordReader(RecordReader):
    """Images under class-named directories → [HWC float array, label_index].

    Reference: ImageRecordReader + ParentPathLabelGenerator + NativeImageLoader
    (resize to height×width×channels). The native decoder (``native``,
    libjpeg/libpng) reads JPEG and PNG; PIL takes other formats, and every
    file when the decoder did not build. Output is NHWC float32 in [0,255]
    (normalizers scale), channel-last. ``native_decodes`` and
    ``fallback_decodes`` count the files each route read.
    """

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None, paths_labels=None):
        self.height = height
        self.width = width
        self.channels = channels
        if root is not None:
            self.labels = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
            self.items = [
                (os.path.join(root, lab, fn), i)
                for i, lab in enumerate(self.labels)
                for fn in sorted(os.listdir(os.path.join(root, lab)))
            ]
        else:
            self.items = list(paths_labels or [])
            self.labels = sorted({l for _, l in self.items})
        self.native_decodes = 0
        self.fallback_decodes = 0

    def _load(self, path: str) -> np.ndarray:
        from deeplearning4j_tpu_torch import native

        if native.image_available():  # NativeImageLoader path (C++ decode)
            try:
                out = native.decode_image_file(
                    path, self.height, self.width, self.channels)
                self.native_decodes += 1
                return out
            except ValueError:
                pass  # non-JPEG/PNG format: PIL fallback below
        from PIL import Image

        self.fallback_decodes += 1
        img = Image.open(path)
        img = img.convert("L" if self.channels == 1 else "RGB")
        img = img.resize((self.width, self.height))
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def _gen(self):
        for path, label in self.items:
            yield [self._load(path), label]


class TransformProcessRecordReader(RecordReader):
    """Applies a TransformProcess to each record of an underlying reader
    (org/datavec/api/records/reader/impl/transform/TransformProcessRecordReader.java)."""

    def __init__(self, reader: RecordReader, transform_process):
        self.reader = reader
        self.tp = transform_process

    def reset(self):
        self.reader.reset()

    def _gen(self):
        for rec in self.reader:
            out = self.tp.execute_record(rec)
            if out is not None:  # filtered rows are dropped
                yield out


class WavFileRecordReader(RecordReader):
    """Audio reader (datavec-data-audio WavFileRecordReader.java parity):
    one record per file = [waveform (n_frames, channels) float32 in [-1,1],
    sample_rate]. Pure-stdlib WAV parse (the reference wraps FFmpeg via
    JavaCPP; WAV covers the tested surface offline)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = [os.fspath(p) for p in paths]

    def _gen(self):
        import wave

        for path in self.paths:
            with wave.open(path, "rb") as w:
                n = w.getnframes()
                raw = w.readframes(n)
                width = w.getsampwidth()
                ch = w.getnchannels()
                if width == 2:
                    arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
                elif width == 1:
                    arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
                elif width == 4:
                    arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
                else:
                    raise ValueError(f"unsupported WAV sample width {width}")
                yield [arr.reshape(-1, ch), w.getframerate()]


class ArrowRecordReader(RecordReader):
    """Arrow IPC/Feather serde (datavec-arrow ArrowRecordReader.java parity
    via pyarrow): one record per row, columns in schema order."""

    def __init__(self, path: str):
        self.path = os.fspath(path)

    def _gen(self):
        import pyarrow.feather as feather

        table = feather.read_table(self.path)
        cols = [c.to_pylist() for c in table.columns]
        for row in zip(*cols):
            yield list(row)


def write_arrow(path: str, records: Sequence[Sequence], column_names: Sequence[str]):
    """Write records (rows) to an Arrow/Feather file (ArrowRecordWriter
    parity)."""
    import pyarrow as pa
    import pyarrow.feather as feather

    cols = list(zip(*records)) if records else [[] for _ in column_names]
    table = pa.table({n: list(c) for n, c in zip(column_names, cols)})
    feather.write_feather(table, os.fspath(path))
    return path


class TfidfRecordReader(RecordReader):
    """TF-IDF vectors from a labelled text corpus.

    Reference parity: datavec-data-nlp's TfidfRecordReader (path-cite,
    mount empty this round) — documents become dense tf-idf rows with the
    label appended, using the same weighting as
    ``nlp.vectorizer.TfidfVectorizer`` (which it wraps). Input layout is
    the reference's label-aware convention: ``root/<label>/<file>.txt``,
    one document per file; or pass explicit ``(text, label)`` pairs.
    """

    def __init__(self, root: str = None, *, documents=None,
                 min_word_frequency: int = 1, append_label: bool = True):
        import os

        from deeplearning4j_tpu_torch.nlp.vectorizer import TfidfVectorizer

        if (root is None) == (documents is None):
            raise ValueError("pass exactly one of root= or documents=")
        if root is not None:
            # store (path, label) and read lazily — the ImageRecordReader
            # convention; the raw corpus never stays pinned in memory
            self.sources = []
            for label in sorted(os.listdir(root)):
                d = os.path.join(root, label)
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    self.sources.append((os.path.join(d, fn), label))
            self._from_files = True
        else:
            self.sources = list(documents)
            self._from_files = False
        self.append_label = append_label
        self.vectorizer = TfidfVectorizer(
            min_word_frequency=min_word_frequency)
        self.vectorizer.fit([self._read(s) for s, _ in self.sources],
                            labels=[l for _, l in self.sources])

    def _read(self, source: str) -> str:
        if not self._from_files:
            return source
        with open(source) as f:
            return f.read()

    def labels(self):
        return list(self.vectorizer.labels)

    def _gen(self):
        for source, label in self.sources:
            row = list(self.vectorizer.transform(self._read(source)))
            if self.append_label:
                row.append(self.vectorizer.labels.index(label))
            yield row
