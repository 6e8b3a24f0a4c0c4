"""RecordReader → DataSet bridge iterators (the port's copy of
deeplearning4j_tpu/datavec/iterators.py).

Reference: org/deeplearning4j/datasets/datavec/RecordReaderDataSetIterator.java
and SequenceRecordReaderDataSetIterator.java (deeplearning4j-core; SURVEY.md
§2.2 J11) — path-cite, mount empty this round.

Semantics mirrored: ``label_index`` picks the label column; ``num_classes``
one-hots classification labels; regression=True keeps raw label values;
image records ([HWC array, label]) batch into NHWC tensors. Sequence variant:
pads ragged sequences and emits (B,T) masks with the reference's
AlignmentMode semantics (align_start default, align_end opt-in) — feeding the
network mask plumbing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


class RecordReaderDataSetIterator(DataSetIterator):
    def __init__(self, reader, batch_size: int, label_index: Optional[int] = None,
                 num_classes: Optional[int] = None, regression: bool = False,
                 preprocessor=None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.preprocessor = preprocessor

    def reset(self):
        self.reader.reset()

    def _to_dataset(self, feats, labels) -> DataSet:
        x = np.asarray(feats, dtype=np.float32)
        if self.label_index is None:
            ds = DataSet(x, x)
        elif self.regression:
            ds = DataSet(x, np.asarray(labels, dtype=np.float32))
        else:
            y = np.zeros((len(labels), self.num_classes), dtype=np.float32)
            y[np.arange(len(labels)), np.asarray(labels, dtype=int)] = 1.0
            ds = DataSet(x, y)
        if self.preprocessor is not None:
            self.preprocessor.pre_process(ds)
        return ds

    def __iter__(self):
        self.reader.reset()
        feats, labels = [], []
        for rec in self.reader:
            if self.label_index is None:
                feats.append([float(v) for v in rec])
            elif len(rec) == 2 and hasattr(rec[0], "ndim"):
                # image record: [array, label]
                feats.append(np.asarray(rec[0], dtype=np.float32))
                labels.append(rec[1])
            else:
                li = self.label_index if self.label_index >= 0 else len(rec) + self.label_index
                lab = rec[li]
                rest = [v for i, v in enumerate(rec) if i != li]
                feats.append([float(v) for v in rest])
                labels.append(
                    [float(lab)] if self.regression else int(float(lab))
                )
            if len(feats) == self.batch_size:
                yield self._to_dataset(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._to_dataset(feats, labels)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → (B, T, F) batches with padding + masks.

    ``alignment_mode`` (AlignmentMode parity): "align_start" (default; data at
    t=0..L-1, padding at the end) or "align_end" (right-aligned so the final
    time steps coincide across the batch — last-step readouts line up)."""

    def __init__(self, reader, batch_size: int, label_index: int = -1,
                 num_classes: Optional[int] = None, regression: bool = False,
                 alignment_mode: str = "align_start"):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        if alignment_mode.lower() not in ("align_start", "align_end"):
            raise ValueError(f"unknown alignment_mode {alignment_mode!r}")
        self.alignment_mode = alignment_mode.lower()

    def reset(self):
        self.reader.reset()

    def _emit(self, seqs) -> DataSet:
        T = max(len(s) for s in seqs)
        nf = len(seqs[0][0]) - 1
        B = len(seqs)
        x = np.zeros((B, T, nf), dtype=np.float32)
        mask = np.zeros((B, T), dtype=np.float32)
        if self.regression:
            y = np.zeros((B, T, 1), dtype=np.float32)
        else:
            y = np.zeros((B, T, self.num_classes), dtype=np.float32)
        for b, seq in enumerate(seqs):
            L = len(seq)
            off = (T - L) if self.alignment_mode == "align_end" else 0
            for t, rec in enumerate(seq):
                li = self.label_index if self.label_index >= 0 else len(rec) + self.label_index
                lab = rec[li]
                feats = [float(v) for i, v in enumerate(rec) if i != li]
                x[b, off + t] = feats
                if self.regression:
                    y[b, off + t, 0] = float(lab)
                else:
                    y[b, off + t, int(float(lab))] = 1.0
            mask[b, off:off + L] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask.copy())

    def __iter__(self):
        self.reader.reset()
        seqs = []
        for seq in self.reader:
            seqs.append(seq)
            if len(seqs) == self.batch_size:
                yield self._emit(seqs)
                seqs = []
        if seqs:
            yield self._emit(seqs)
