"""The port's DataVec (``deeplearning4j_tpu_torch/datavec``), its TF-IDF
vectorizer and its bucketing spec against the reference.

The reference's own cases of ``tests/test_datavec.py`` and
``tests/test_nlp_vectorizer.py`` run here on the port (``_torch_port_cases``);
the tests below run the same readers, transforms, executors and iterators
of both packages on the same seeded files and records and require equal
results: records, schemas and batches equal, masks equal in both alignment
modes.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

import deeplearning4j_tpu.data.bucketing as ref_bucketing  # noqa: E402
import deeplearning4j_tpu.datavec as ref_dv  # noqa: E402
import deeplearning4j_tpu.nlp.vectorizer as ref_vec  # noqa: E402
import deeplearning4j_tpu_torch.data.bucketing as port_bucketing  # noqa: E402
import deeplearning4j_tpu_torch.datavec as port_dv  # noqa: E402
import deeplearning4j_tpu_torch.nlp.vectorizer as port_vec  # noqa: E402

_datavec_cases = port_copy("test_datavec")
expose(_datavec_cases, [
    "test_csv_record_reader", "test_line_and_regex_readers",
    "test_svmlight_reader", "test_csv_sequence_reader_and_iterator",
    "test_image_record_reader",
    "test_record_reader_dataset_iterator_classification",
    "test_transform_process_schema_and_records",
    "test_transform_conditional_rename_reorder_time",
    "test_transform_process_record_reader",
    "test_sequence_iterator_align_end", "TestRound2DataVec",
    "TestTransformBreadth", "TestReducer", "test_int_math_java_semantics",
    "test_int_to_categorical_range_checked", "test_int_math_exact_above_2_53",
    "test_fillna_covers_nan"], globals())
_vectorizer_cases = port_copy("test_nlp_vectorizer")
expose(_vectorizer_cases, ["TestBagOfWords", "TestTfidf",
                           "TestTfidfRecordReader"], globals())

PACKAGES = (ref_dv, port_dv)


def _both(fn):
    """fn(package) for the reference and the port."""
    return [fn(dv) for dv in PACKAGES]


def _equal(a, b):
    """Records, lists, arrays and DataSets equal in value and type, NaN
    equal to NaN."""
    if hasattr(a, "features"):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            _equal(getattr(a, f), getattr(b, f))
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, float) and a != a:
        assert isinstance(b, float) and b != b
        return
    assert type(a) is type(b) and a == b, (a, b)


@pytest.fixture
def corpus(tmp_path):
    """Seeded files for every reader: a CSV with a quoted cell and a
    blank line, ragged sequence files, lines for the regex reader, an
    SVMLight file, a WAV file and a directory of PNG and JPEG images."""
    from PIL import Image

    rng = np.random.default_rng(7)
    csv = tmp_path / "rows.csv"
    rows = [",".join(f"{v:.3f}" for v in rng.uniform(-5, 5, 4)) + f",{i % 3}"
            for i in range(40)]
    rows.insert(3, '"quoted, text",1,2,3,0')
    csv.write_text("\n".join(rows[:20]) + "\n\n" + "\n".join(rows[20:]) + "\n")
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, length in enumerate((3, 7, 5, 1, 6)):
        lines = [",".join(f"{v:.4f}" for v in rng.normal(size=3)) +
                 f",{t % 2}" for t in range(length)]
        (seq / f"s{i}.csv").write_text("\n".join(lines) + "\n")
    (tmp_path / "log.txt").write_text(
        "\n".join(f"id={i} v={i * 1.5}" for i in range(10)) + "\n")
    (tmp_path / "data.svm").write_text(
        "1 1:0.5 3:2.0\n0 2:1.25 # comment\n\n1 4:-3\n")
    import wave
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(rng.integers(-30000, 30000, 64,
                                   dtype=np.int16).tobytes())
    img = tmp_path / "img"
    for c, (fmt, ext) in enumerate((("PNG", "png"), ("JPEG", "jpg"))):
        (img / f"class{c}").mkdir(parents=True)
        for i in range(3):
            a = rng.integers(0, 256, (13 + 2 * i, 17, 3), dtype=np.uint8)
            Image.fromarray(a).save(img / f"class{c}" / f"i{i}.{ext}", fmt)
    return tmp_path


def test_readers_equal(corpus):
    """Every reader yields the same records in both packages."""
    def read(dv):
        from deeplearning4j_tpu_torch.datavec import records as port_rec
        rec = port_rec if dv is port_dv else sys.modules[
            "deeplearning4j_tpu.datavec.records"]
        readers = [
            dv.CSVRecordReader(str(corpus / "rows.csv"), skip_lines=1),
            dv.CSVSequenceRecordReader(str(corpus / "seq")),
            dv.LineRecordReader(str(corpus / "log.txt"), skip_lines=2),
            dv.RegexLineRecordReader(str(corpus / "log.txt"),
                                     r"id=(\d+) v=([\d.]+)"),
            dv.SVMLightRecordReader(str(corpus / "data.svm"), 5),
            dv.CollectionRecordReader([[1, "a"], [2.5, "b"]]),
            rec.WavFileRecordReader([str(corpus / "a.wav")]),
            dv.ImageRecordReader(9, 11, 3, root=str(corpus / "img")),
            dv.ImageRecordReader(6, 5, 1, root=str(corpus / "img")),
        ]
        out = [list(r) for r in readers]
        # the record API: has_next / next_record walk the same records
        r = dv.CSVRecordReader(str(corpus / "rows.csv"))
        walked = []
        while r.has_next():
            walked.append(r.next_record())
        return out + [walked]

    ref, port = _both(read)
    _equal(ref, port)


def test_csv_reader_takes_a_list_of_files(corpus):
    """The port's CSVRecordReader reads a list of files one after another,
    each the reference's reader of that file."""
    a, b = corpus / "seq" / "s1.csv", corpus / "seq" / "s2.csv"
    want = list(ref_dv.CSVRecordReader(str(a))) + list(
        ref_dv.CSVRecordReader(str(b)))
    _equal(want, list(port_dv.CSVRecordReader([str(a), str(b)])))


def test_image_reader_counts_native_and_fallback(corpus):
    from PIL import Image

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        corpus / "img" / "class0" / "z.bmp", "BMP")
    rr = port_dv.ImageRecordReader(8, 8, 3, root=str(corpus / "img"))
    assert len(list(rr)) == 7
    assert (rr.native_decodes, rr.fallback_decodes) == (6, 1)


def _transform(dv):
    """A TransformProcess with every column-op family, a Join and a
    Reducer, run on seeded records."""
    S, TP, CT = dv.Schema, dv.TransformProcess, dv.ColumnType
    schema = (S.builder().add_column_string("name")
              .add_column_categorical("color", "red", "green", "blue")
              .add_column_integer("age").add_column_double("score")
              .add_column_string("ts").add_column_string("tag").build())
    tp = (TP.builder(schema)
          .replace_missing_value_with("age", 0)
          .filter_invalid_values("score")
          .filter(lambda r, s: r[s.column_index("age")] > 90)
          .categorical_to_one_hot("color")
          .integer_math_op("age", "Modulus", 7)
          .duplicate_column("age", "age2")
          .integer_to_categorical("age2", [str(i) for i in range(7)])
          .categorical_to_integer("age2")
          .double_math_op("score", "multiply", 1.5)
          .double_column_transform("score", lambda v: v - 0.25)
          .normalize("score", -10.0, 10.0)
          .standardize("score", 0.1, 2.0)
          .conditional_replace_value_transform("score", 0.0,
                                               lambda v: v < -1.0)
          .string_to_time("ts", "%Y-%m-%d %H:%M")
          .derive_column_from_time("ts", "hour_of_day")
          .derive_column_from_time("ts", "day_of_week")
          .change_case_string_transform("name", upper=True)
          .replace_string_transform("name", "A", "4")
          .append_string_column_transform("name", "!")
          .map_string("tag", lambda v: v[::-1])
          .string_to_categorical("tag", ["x", "y", "z"])
          .add_constant_column("src", CT.String, "seed")
          .convert_to_double("age")
          .convert_to_integer("age")
          .rename_column("score", "s")
          .reorder_columns("s", "name")
          .remove_columns("tag")
          .build())
    rng = np.random.default_rng(3)
    recs = []
    for i in range(60):
        recs.append([
            f"name{i}a", ["red", "green", "blue"][i % 3],
            None if i % 11 == 0 else int(rng.integers(0, 100)),
            float("nan") if i % 13 == 5 else float(rng.normal(0, 4)),
            f"2021-0{1 + i % 9}-1{i % 10} {i % 24:02d}:{i % 60:02d}",
            ["x", "y", "z"][i % 3]])
    out = tp.execute(recs)
    final = tp.final_schema()
    keep = (TP.builder(schema).remove_all_columns_except_for("name", "age")
            .build().execute(recs[:5]))
    left = S.builder().add_column_integer("id").add_column_string("n").build()
    right = S.builder().add_column_integer("id").add_column_double("v").build()
    L = [[i % 5, f"l{i}"] for i in range(8)]
    R = [[i % 7, i * 0.5] for i in range(9)]
    joins = [dv.Join(kind, ["id"], left, right).execute(L, R)
             for kind in ("Inner", "LeftOuter", "RightOuter", "FullOuter")]
    red_schema = (S.builder().add_column_string("k").add_column_double("v")
                  .add_column_integer("c").build())
    groups = [[f"k{i % 4}", float(rng.normal()), int(i)] for i in range(30)]
    reds = [dv.Reducer(red_schema, ["k"], default_op=op).execute(groups)
            for op in ("sum", "mean", "min", "max", "count", "stdev")]
    red = (dv.Reducer.Builder(red_schema, "k").mean_columns("v")
           .sum_columns("c").build())
    return (out, final.column_names(),
            [str(final.column_type(n)) for n in final.column_names()],
            keep, joins, reds, red.execute(groups),
            red.output_schema().column_names())


def test_transform_process_join_reducer_equal():
    ref, port = _both(_transform)
    assert ref[0], "the transform kept no record"
    _equal(ref, port)


@pytest.mark.parametrize("num_workers", [2, 3])
def test_multiprocess_executor_equals_serial_in_both(num_workers):
    """MultiProcessTransformExecutor (fork-started workers, contiguous
    chunks) gives the serial records, in both packages, and the packages
    agree."""
    def run(dv):
        S, TP = dv.Schema, dv.TransformProcess
        schema = (S.builder().add_column_integer("i")
                  .add_column_double("v").build())
        tp = (TP.builder(schema)
              .filter(lambda r, s: r[0] % 5 == 0)
              .double_math_op("v", "multiply", 3.0)
              .integer_math_op("i", "Add", 7).build())
        recs = [[i, i * 0.25] for i in range(400)]
        serial = dv.LocalTransformExecutor.execute(recs, tp)
        ex = dv.MultiProcessTransformExecutor(tp, num_workers=num_workers,
                                              min_records_per_worker=16)
        par = ex.execute(recs)
        assert par == serial
        return par

    ref, port = _both(run)
    _equal(ref, port)


def test_parallel_record_reader_iterator_equal(corpus):
    def run(dv):
        schema = (dv.Schema.builder().add_column_double("a", "b", "c", "d")
                  .add_column_integer("label").build())
        tp = (dv.TransformProcess.builder(schema)
              .convert_to_double("a", "b", "c", "d")
              .convert_to_integer("label").build())
        rr = dv.ParallelTransformRecordReader(
            dv.CSVRecordReader(str(corpus / "rows.csv"), skip_lines=4),
            tp, num_workers=2)
        rr.executor.min_records_per_worker = 8
        return list(dv.RecordReaderDataSetIterator(rr, 8, label_index=4,
                                                   num_classes=3))

    ref, port = _both(run)
    assert len(ref) == 5
    _equal(ref, port)


@pytest.mark.parametrize("kind", ["classification", "regression",
                                  "no_label", "image"])
def test_record_reader_iterator_batches_equal(corpus, kind):
    def run(dv):
        if kind == "image":
            rr = dv.ImageRecordReader(10, 12, 3, root=str(corpus / "img"))
            return list(dv.RecordReaderDataSetIterator(
                rr, 4, label_index=1, num_classes=2))
        rr = dv.CSVRecordReader(str(corpus / "rows.csv"), skip_lines=4)
        if kind == "classification":
            return list(dv.RecordReaderDataSetIterator(
                rr, 16, label_index=-1, num_classes=3))
        if kind == "regression":
            return list(dv.RecordReaderDataSetIterator(
                rr, 16, label_index=0, regression=True))
        return list(dv.RecordReaderDataSetIterator(rr, 16))

    ref, port = _both(run)
    assert ref
    _equal(ref, port)


@pytest.mark.parametrize("alignment", ["align_start", "align_end"])
@pytest.mark.parametrize("regression", [False, True])
def test_sequence_iterator_batches_and_masks_equal(corpus, alignment,
                                                   regression):
    """Ragged sequences pad to the batch's longest with (B, T) masks, in
    both alignment modes, equal in both packages."""
    def run(dv):
        rr = dv.CSVSequenceRecordReader(str(corpus / "seq"))
        return list(dv.SequenceRecordReaderDataSetIterator(
            rr, 2, label_index=-1, num_classes=None if regression else 2,
            regression=regression, alignment_mode=alignment))

    ref, port = _both(run)
    assert [b.features.shape for b in port] == [(2, 7, 3), (2, 5, 3),
                                                (1, 6, 3)]
    _equal(ref, port)
    m = port[0].features_mask
    if alignment == "align_end":
        np.testing.assert_array_equal(m[0], [0, 0, 0, 0, 1, 1, 1])
    else:
        np.testing.assert_array_equal(m[0], [1, 1, 1, 0, 0, 0, 0])


def test_tfidf_vectorizer_and_reader_equal(corpus):
    docs = [("the cat sat on the mat", "a"), ("the dog ate the cat", "b"),
            ("a dog and a cat", "a"), ("mat dog mat", "b")]
    out = []
    for vec, dv in ((ref_vec, ref_dv), (port_vec, port_dv)):
        v = vec.TfidfVectorizer(min_word_frequency=1)
        v.fit([d for d, _ in docs], labels=[l for _, l in docs])
        b = vec.BagOfWordsVectorizer(min_word_frequency=2)
        b.fit([d for d, _ in docs])
        out.append([v.transform("the cat and the mat"),
                    v.vectorize("dog cat", "b"), b.transform("dog mat mat"),
                    sorted(v.vocab.items()),
                    list(dv.TfidfRecordReader(documents=docs))])
    _equal(*out)


@pytest.mark.parametrize("spec", ["", "none", "pow2", "batch=8,16,32",
                                  "batch=pow2;seq=64,128", "seq=pow2",
                                  " batch = 4,8 ; seq = 16 "])
def test_bucket_spec_parses_as_the_reference(spec):
    ref = ref_bucketing.BucketingPolicy.from_spec(spec)
    port = port_bucketing.BucketingPolicy.from_spec(spec)
    if ref is None:
        assert port is None
    else:
        assert (port.batch_buckets, port.seq_buckets) == (
            ref.batch_buckets, ref.seq_buckets)


def test_bucket_spec_refuses_what_the_reference_refuses():
    for spec in ("time=8", "batch=8;depth=2"):
        with pytest.raises(ValueError, match="unknown axis"):
            ref_bucketing.BucketingPolicy.from_spec(spec)
        with pytest.raises(ValueError, match="unknown axis"):
            port_bucketing.BucketingPolicy.from_spec(spec)


@pytest.mark.parametrize("buckets", [(1, 2, 4, 8, 16, 32), (8, 16), "pow2",
                                     None])
def test_plan_serving_batch_cap_as_the_reference(buckets):
    ref = ref_bucketing.BucketingPolicy(batch_buckets=buckets)
    port = port_bucketing.BucketingPolicy(batch_buckets=buckets)
    for n in (1, 3, 7, 16, 33, 70):
        for cap in (None, 1, 5, 8, 12, 40):
            assert port.plan_serving_batch(n, cap=cap) == \
                ref.plan_serving_batch(n, cap=cap), (n, cap)


def test_env_buckets_become_builder_defaults(monkeypatch):
    """DL4J_TPU_BUCKETS sets the default buckets of a new conf in both
    packages; a malformed spec fails at the builder."""
    import deeplearning4j_tpu.config as ref_config
    import deeplearning4j_tpu.nn.conf as ref_conf
    import deeplearning4j_tpu_torch.config as port_config
    import deeplearning4j_tpu_torch.nn.conf as port_conf
    from deeplearning4j_tpu.nn.layers import OutputLayer as RefOut
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer as PortOut

    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg.Environment, "_instance", None)
    monkeypatch.setenv("DL4J_TPU_BUCKETS", "batch=4,8;seq=pow2")
    confs = []
    for mod, out in ((ref_conf, RefOut), (port_conf, PortOut)):
        b = mod.NeuralNetConfiguration.builder()
        confs.append(b.list().layer(out(n_in=2, n_out=2)).build())
    assert (confs[1].batch_buckets, confs[1].seq_buckets) == (
        confs[0].batch_buckets, confs[0].seq_buckets) == ((4, 8), "pow2")
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg.Environment, "_instance", None)
    monkeypatch.setenv("DL4J_TPU_BUCKETS", "depth=3")
    with pytest.raises(ValueError, match="DL4J_TPU_BUCKETS"):
        port_conf.NeuralNetConfiguration.builder()
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg.Environment, "_instance", None)
