#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py          # from the root of a checkout

Drives the port (``deeplearning4j_tpu_torch``) only, and imports nothing
of the JAX package. Phases 3-18b run under ``capture.disabled()``,
eagerly, as they did before the compiled step (their per-launch checks
need every launch to go through a wrapper, and their rates are the eager
ones); phases 19-22c run with the compiled step (``nn/capture.py``) on.
Phases, each printing one JSON line:

1. device: the card's name and power limit; TF32 off for matmuls and convs.
2. build: the CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` with nvcc
   (one process per source, all started together).
3. kernel: the conv kernel against its plain PyTorch version on every
   distinct conv geometry of the 224x224 ResNet-50 forward (enumerated from
   the port's own conf) at batch 8, plus dilated + grouped, odd-channel
   and row-tiled cases, in fp32 (rtol 1e-4, atol 1e-4) and bf16 (rtol 8e-3,
   atol 1e-4: two bf16 ulps on the same bf16 inputs), with the kernel's,
   the plain version's and ``F.conv2d``'s times, the card's bound, and the
   body the kernel library picked (fp32 ``fma``; bf16 ``wgmma`` where Cg
   and Og are multiples of 64, else ``mma_sync``) with its K slices.
4. kernel_grad: the gradient kernels -- wgrad (``csrc/conv2d_wgrad.cu``)
   and dgrad (the conv kernel over the undilated dy, split by stride phase,
   one launch) -- against their plain versions at the same geometries at
   batch 8, fp32 and bf16, gated on the error normalised by the largest
   output (GRAD_TOL below), with kernel, plain, ``torch.nn.grad`` (cuDNN)
   times, the bound, wgrad's body and splits as its plan reports them
   (bf16 ``wgmma`` for one group of Cin and Cout multiples of 64, else
   ``mma_sync``) and dgrad's body and phases.
5. serve: full-width ResNet-50 (224x224x3, 1000 classes, random weights
   from seed 12345) behind ModelServer -> ModelRouter -> BatchScheduler ->
   ServingModel; 8 HTTP requests of 1-16 rows, some concurrent. Every
   response must hold probabilities that sum to 1 and match ``net.output``
   on the plain path within 1e-4; the conv kernel must have launched 53
   times per executed chunk and the plain path never on a CUDA tensor;
   each of those launches is held against the plain version on its own
   tensors (``check_every_launch``).
   Then ``net.output`` forward images/sec at batch 32 in fp32 and bf16
   (RATE_WINDOWS windows of RATE_WINDOW_S each: median, min, max; 3 of
   0.5 s since the serving slice, 5 of 2 s before), and one profiled
   batch-32 forward of each: device time by kernel, idle share.
6. train: full-width ResNet-50 training at batch 32 (seed 12345, random
   one-hot labels, the zoo's Adam(1e-3)): one step's loss and gradients
   under ``auto`` against ``exact`` (53 / 53 / 52 launches of fwd / wgrad /
   dgrad, none plain on CUDA; gradients held to an fp64 step, see
   ``_grad_parity``), two controls the gradient gate must fail (TF32 on
   the plain path, wgrad on bf16-rounded operands), four ``fit`` steps
   whose loss must fall (the main path: its launches are the kernels
   line's, and each is held against its plain version on its own batch-32
   tensors), one bf16 ``fit`` step checked the same way, ``fit``
   images/sec in fp32 and bf16 (RATE_WINDOWS windows), one profiled step of
   each.
7. attention_kernel: the flash-attention kernel (``csrc/flash_fwd.cu``, K5)
   against its plain version on ATTENTION_CASES below (BERT-base heads of
   64 at batch 8, S 128 and 512; D 128; a ragged S of 1000; batch 1 and 32
   at S 512, where the bf16 body takes 64 and 128 query rows per block),
   fp32 and bf16: no mask, causal, and a padding mask with a fully-masked
   batch row; O and the LSE gated by ATTN_TOL and LSE_TOL below; the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   times, the card's bound and the rows per block; the raw launch must
   refuse inputs that require grad, and ``flash_attention`` on them must
   give an O with a grad_fn (the FlashAttention autograd Function).
8. attention_sweep: the kernel against the port's exact attention from 32
   to 2048 tokens (8192 tokens per batch), fp32 and bf16: the crossover
   ``ops/attention.py``'s FLASH_MIN_SEQ is set from.
9. bert_serve: full-width BERT-base (hidden 768, 12 layers, 12 heads, FFN
   3072, 512 positions, 2 classes; random weights from seed 12345, the
   flash kernel forced) behind ModelServer; 8 HTTP requests of 1-16 rows
   of 512 tokens. Answers within 1e-4 of the plain path; 12 flash launches
   per executed chunk, none plain on CUDA, each held against the plain
   version on its own tensors.
10. bert_forward: ``net.output`` sequences/sec at batch 32, S 128 and 512,
    fp32 and bf16; one forward with a ragged padding mask in each type
    (every launch checked; fp32's answer against the plain path); one
    profiled batch-32 S=512 forward in each type by class (flash kernel
    and its share, matmuls, layer norm, gelu, embedding gather, idle
    share).
11. bert_train: full-width BERT-base training on MultiLayerNetwork
    (seed 12345, hidden_dropout 0.1, Adam(1e-5)) on BertIterator batches of
    32 at S 128 over lines of SURVEY.md and ROADMAP.md (the label: the file
    a line comes from; the vocabulary ``Vocab.build`` of the same lines):
    one step under ``auto`` against ``exact`` with dropout off (loss 1e-5
    relative, gradients by the fp64 step gate, 12 K5 launches); the
    FlashAttention Function alone at batch 8 and 32, S 128 and 512, no
    mask, causal and padding with a fully-masked row, fp32 and bf16: dq,
    dk, dv against the exact attention's fp64 autograd (FLASH_BWD_TOL), and
    at batch 32 its backward's time beside SDPA's and the exact path's and
    its bound; the main path, three epochs of ``fit(iterator)`` with every
    K5 launch checked and the mean loss of the last 10 steps below the
    first 10's and below the class prior's ln 2; one checked bf16 step on integer ids; three masked-LM steps,
    then TransferLearning to a classifier on frozen embeddings, three
    steps, the frozen params bit-equal; train sequences/sec at S 128 and
    512, fp32 and bf16; one profiled step in each type (K5, the flash
    backward, matmuls, layer norm's forward, Adam, idle share).
12. lstm_kernel: K4 at the char-RNN's geometries, both gate orders, fp32
    and bf16, gated by LSTM_TOL. The one-step cell kernel
    (``csrc/lstm_cell.cu``) at training (B 32, H 256) and sampling (B 4,
    H 256) on a strided time slice: its time (one launch alone, and per
    launch of 50 in one CUDA graph), the plain version's, the library
    route's (``torch.addmm`` + ``torch._thnn_fused_lstm_cell``) and cuDNN
    ``nn.LSTM``'s per step, the bound. The segment kernel
    (``csrc/lstm_seq.cu``, the main path's) at (B 32, T 50) and (B 4,
    T 1), with and without a ragged mask, on y, the carries and the final
    state: the segment's time and per step, the step body's at the same
    geometry, the plain version's, the library route per step (50 steps in
    one CUDA graph) and per segment, cuDNN ``nn.LSTM`` over the same
    segment, the bound per segment, the body that ran.
13. char_rnn_train: full-width TextGenerationLSTM (47 characters, 256
    units, dropout 0.2, Adam(1e-3), seed 12345) at dl4j-examples'
    LSTMCharModellingExample shape (batch 32, 1000 characters of SURVEY.md
    per sequence, TBPTT 50: 20 updates and 40 K4 launches per ``fit``
    call, one per segment and layer): one segment's step under ``auto``
    against ``exact`` with dropout off (loss 1e-5 relative, gradients by
    the fp64 step gate), the main path (CHAR_FITS ``fit`` calls, every K4
    launch held against its plain version, none plain on CUDA, the loss of
    the last five segments below the first five's), one checked bf16
    ``fit`` call, train characters/sec fp32 and bf16 (RATE_WINDOWS of one
    ``fit`` call), one profiled segment (device busy, idle share, K4's
    launches and share).
14. char_rnn_sample: 4 samples of 300 characters with ``rnn_time_step``
    after a 9-character prime (one call: 2 K4 launches; then 2 K4 launches
    per character step at batch 4, each checked), from the trained fp32
    net and from the bf16 net of its one ``fit`` call: characters/sec and
    a 60-character excerpt of each.
15. lenet: LeNet-5 (``zoo.LeNet``: conv 5x5 -> 20, pool, conv 5x5 -> 50,
    pool, dense 500, softmax 10; seed 12345, Adam(1e-3), fp32) as
    dl4j-examples' LeNetMNIST trains it, on the reference's synthetic
    MNIST (60,000 training and 10,000 test digits, MnistDataSetIterator at
    batch 64): one step under ``auto`` against ``exact`` (2 / 1 / 2 conv
    launches of fwd / dgrad / wgrad, the fp64 step gate); the main path,
    one epoch of ``fit(iterator)`` (938 steps, the last of 32) with
    ScoreIterationListener(100), PerformanceListener(100) and
    CollectScoresListener(1), every conv launch held against its plain
    version, none plain on CUDA, every iteration seen once in order, the
    mean of the last 50 scores below the first 50's; its first 200 steps
    again at ``sync_every`` 16 (the same scores within 1e-6, one host copy
    a window); ``evaluate`` on the test digits (accuracy >= 0.97, all
    10,000 rows counted, the ``exact`` path's confusion matrix but for
    rows whose top two probabilities lie within 1e-4) and ``score``
    against ``exact`` (1e-5); EarlyStoppingTrainer on 6,000 digits (at
    most 3 epochs, patience 1; the best model on the card re-scores to its
    recorded score within 1e-6); a checked bf16 run of 200 steps (every
    launch on mma.sync) and its ``evaluate``; train images/sec fp32 and
    bf16 (RATE_WINDOWS windows of 200 steps), ``evaluate`` images/sec at
    batch 1024, one profiled step of each (device busy, idle share, the conv
    kernels' share). LeNet's two conv geometries at batch 64 are extra
    cases of phases 3 and 4 (marked ``lenet``).
16. recurrent_layers: each layer, wrapper, head and vertex of the
    recurrent slice on CUDA tensors against the same layer on the CPU
    (the same params, a seeded input and (B, T) ragged mask, fp32 and
    bf16, the output and the gradients of every param and the input,
    LAYER_TOL): GravesLSTM, GRU with and without ``b_rec``, SimpleRnn,
    Bidirectional(LSTM) in its four modes (K4 once a direction),
    GravesBidirectionalLSTM, LastTimeStep, RnnLossLayer, GlobalPooling
    over time (four types), the two recurrent vertices, and ConvLSTM2D at
    B 8, T 10, 64x64x1 -> 64 filters, 3x3, with and without
    ``return_sequences`` (the conv kernel on the B*T images and once a
    step, its dgrad and wgrad in the backward). Every K1, dgrad, K3 and K4
    launch checked, none plain, the counts against the ones worked out
    from the code (expected_recurrent_launches).
17. graves_char_rnn: BASELINE #3's form, the GravesLSTM char-RNN on
    MultiLayerNetwork (two GravesLSTM of 200, softmax over CHAR_SET) at the
    char_rnn_train shape: a segment's step against ``exact`` and fp64,
    CHAR_FITS ``fit`` calls whose loss falls, no kernel launched (the
    reference's GravesLSTM is a jnp scan), a bf16 ``fit`` call, train
    characters/sec fp32 and bf16 beside char_rnn_train's K4 rates, a
    profiled segment, sampled characters/sec.
18. seq_graph: the masked ComputationGraph on K4 at dl4j-examples'
    Word2VecSentimentRNN shape (batch 64, reviews of 32-256 steps, 300
    features, LSTM 256, 2 classes; seeded data): (i) LSTM -> RnnOutputLayer
    with the label at each review's last step, (ii) Bidirectional(LSTM) ->
    masked average -> OutputLayer. For each: a step against ``exact`` and
    fp64, two epochs of ``fit(iterator)`` over 32 batches with every K4
    launch checked (1 a step, 2 a step) and the loss falling, ``evaluate``
    and ``score`` with masks against ``exact``, a checked bf16 step, train
    sequences/sec fp32 and bf16, a profiled step. Then TextGenerationLSTM
    rebuilt as a graph with TBPTT 50: one ``fit`` call (40 K4 launches)
    and ``rnn_time_step`` against the MultiLayerNetwork's.
18b. op_table: every registered op name and alias (ops/op_cases.py's
    seeded case) on CUDA tensors against the same call on the CPU, to its
    family's tolerance (op_cases.TOLERANCES; random ops by moments,
    decompositions by reconstruction); then the kernel-backed ops by name
    at full width, fp32 and bf16: conv2d_backprop_input/filter at every
    ResNet-50 conv geometry at batch 8 (dgrad, K3), depthwise_conv2d and
    separable_conv2d at Xception's first separable block (K1),
    lstm_layer at the char-RNN's width in every direction and layout with
    ragged seq_lens (K4 once a direction; fp32 also against the CPU, its
    gradients too), conv_lstm_2d at ConvLSTM2D's shape (K1). Every launch checked, none
    plain, the counts against expected_op_table_launches.
18c. conv_zoo, conv_zoo_captured: Xception (299x299, batch 32) served
    and trained on K1, dgrad and K3 at up to 1,536 groups, every launch
    checked; the depthwise kernel records; the other eight zoo models;
    Xception's fit captured (after 18b, the second outside
    ``capture.disabled()``).
18d. keras_import: tf.keras's MobileNetV2 (224x224x3, 1000 classes,
    alpha 1.0, 3,538,984 params and statistics) written as a legacy
    Keras HDF5 file by ``imports/keras_cases.py`` (seed 12345) and
    imported by ``KerasModelImport`` onto the card: the forward at batch
    32 under auto, fp32 and bf16, every K1 launch checked (52 a pass),
    features, fp64 logits and probabilities against the exact path
    (KERAS_TOL; bf16 LAYER_TOL's forward gate); a ModelSerializer
    archive of it served through ``ModelRouter.load`` over HTTP (within
    1e-4 of the exact path); its head made an OutputLayer under
    Adam(1e-3): a step under auto against exact and fp64 with the gate's
    controls (TF32 must fail), four checked fp32 steps whose loss must
    fall, four checked bf16 steps, 52 / 51 / 52 K1 / dgrad / K3 launches
    a step as the conf works out, none plain; images/sec forward and
    fit; K1, dgrad and K3 against their plain versions and cuDNN at its
    ten depthwise geometries (stride 1 and the four stride-2 ones, batch
    8); the small leg (keras_small): a Conv1D stack (K1), a
    depth_multiplier-2 stride-2 depthwise layer (K1) and the char-RNN's
    LSTM (K4) imported from keras_cases files, the card against the CPU
    within 1e-4, and each class of nn/layers_spatial.py forward and
    backward on the card against the CPU (LAYER_TOL), every launch
    checked. keras_import_captured: its fit captured, fp32 and bf16,
    under the capture gate, with captured images/sec beside the eager.
19. capture_serve: full-width ResNet-50 behind the ModelServer, its
    forwards captured: ``warmup`` (the server's start) captures a CUDA
    graph a batch bucket (1-32; each program's pool bytes printed); the
    ``serve`` requests again, every chunk the server ran equal to the bit
    to the eager forward of the same chunk, 53 K1 launches a chunk under
    replay, none plain; served rows/s and forward images/sec at batch 32,
    fp32 and bf16, beside the eager ones of phase 5; a bf16 net's forward
    after a captured ``fit`` step equal to its eager forward.
20. capture_train: ResNet-50 ``fit`` at batch 32, Adam(1e-3), fp32 and
    bf16: CAPTURE_STEPS steps under the captured-against-eager gate
    (``capture_gate``: eager twice, then captured, from one state; bit for
    bit where the eager runs agree, else the nondeterministic kernels are
    named and the gate is made again under deterministic algorithms), 53 /
    52 / 53 K1 / dgrad / K3 launches a step under replay, none plain; train
    images/sec (``captured_rate``) and a profiled captured step (busy, idle
    share, wall) beside phase 6's eager ones.
21. capture_bert_train: BERT-base ``fit`` at batch 32, S 128, dropout 0.1,
    fp32 and bf16, CAPTURE_STEPS BertIterator batches under the gate (the
    first loss, its dropout masks drawn under replay, equal to the bit), 12
    K5 launches a step under replay; train sequences/sec and a profiled
    captured step beside phase 11's.
22. capture_small: the char-RNN's TBPTT (a fit call: 40 K4 launches),
    LeNet, the GravesLSTM char-RNN (the gate on 200 characters) and the
    two sentiment graphs (a program a ``seq_buckets`` bucket), each under
    the gate with its launches, its captured rate and a profiled captured
    step beside its eager phase's; the RecompileListener over a ragged
    LeNet epoch (no event with ``batch_buckets``, one without), and the
    CompileWatcher's counts (every phase line carries the programs it
    built under ``built``); capture_gc: LeNet captured while a dead
    captured LeNet waits for the collector, a collection forced wherever
    the collector is on inside the capture (it must be off).
22b. serialize, after the capture phases (so ResNet-50's train step is
    captured after dozens of captured networks have died, the order in
    which a collection inside a capture once broke it): ModelSerializer on
    the card (serialize_resnet, serialize_bert, serialize_lenet), the
    compiled step on: ResNet-50 restored and resumed bit for bit;
    BERT-base (S 512) served from an archive over HTTP bit for bit to its
    writer, reloaded to a newer archive (version 2), a truncated archive
    refused with version 2 still answering; LeNet's CheckpointListener
    (keep 2), normalizer and LocalFileModelSaver.
22c. checkpoint: ShardedCheckpointer(keep=3) with async saves on LeNet,
    a corrupted newest step skipped, and a FaultTolerantTrainer run
    stopped by a fault and resumed bit for bit to an uninterrupted one.
22d. samediff_tf_bert: full-width BERT-base (hidden 768, 12 layers, 12
    heads, FFN 3072, vocabulary 30,522, 512 positions, 2 classes; seed
    12345) written as a frozen TF GraphDef (``imports/graph_cases.py``,
    from the zoo net's params) and imported from bytes by
    ``import_graph_def``: its probabilities at batch 32, S 128 within 1e-4
    of ``net.output`` (flash off) and of the same graph in fp64 on the
    card, no kernel launched (the imported attention is MatMul/Softmax);
    every weight made a variable, a softmaxCrossEntropy head on a label
    placeholder, Adam(1e-5): the first step's gradients by the fp64 step
    gate, then ``fit`` (captured) for BERT_TRAIN_EPOCHS epochs of the
    bert_train batches, the last 10 steps' mean loss below the first
    10's; SameDiff BERT samples/sec of ``output`` and ``fit``, eager and
    captured (RATE_WINDOWS windows); one profiled eager step by class.
22e. samediff_save: that trained graph saved with its updater state and
    loaded on the card: arrays, Adam moments and the iteration bit for
    bit; outputs (captured and eager) and one more eager ``fit`` step
    (under deterministic algorithms) bit for bit the writer's.
22f. samediff_tf_resnet: full-width ResNet-50 (224x224x3, 1000 classes)
    as a frozen TF GraphDef from ``graph_cases`` at batch 32: the forward's
    53 K1 launches each checked, within 1e-4 of the ``exact`` route; the
    53 conv kernels made variables, 4 eager ``fit`` steps with 53 / 52 /
    53 K1 / dgrad / K3 launches each, every one checked, the loss falling;
    images/sec forward and ``fit``, eager and captured; a captured step's
    launches under replay.
22g. samediff_onnx_lstm: the char-RNN's LSTM (47 -> 256, B 32, T 50) as an
    ONNX model from ``graph_cases``, on the card against the CPU:
    ``output`` and ``calculate_gradients`` (W, R, B) within 1e-4 of the
    largest CPU value, K4 once in each, every launch checked, eager and
    captured.
22h. data_pipeline: the host data pipeline. The native library (CSV and
    image loaders, ``native/csrc``) built with g++ (seconds; whether the
    image decoder built, with the compiler's error and the host's
    libjpeg/libpng headers and libraries where it did not); the
    synthetic digits of phase 15 written as 8 MNIST-format CSV shards
    (60,000 rows of a label and 784 pixels 0-255), DP_IMAGES images in
    DP_CLASSES class folders (PNGs written here with zlib, the committed
    JPEG fixtures of tools/fixtures/jpeg) and DP_SEQ_BATCHES x 64 review
    files of 300 values a row; CSV parse MB/s and rows/s at 1, 2, 4 and 8
    threads, image decode images/s at 1, 4 and 8 threads, pinned and
    pageable H2D GB/s; DP_STRESS pipelines of 4 files on 4 threads with a
    ring of 1, each file in order and equal to the single-threaded parse;
    MultiProcessTransformExecutor forked after CUDA is initialised, equal
    to serial. Leg (a): LeNet-5 trained through CSVRecordReader ->
    RecordReaderDataSetIterator for the first DP_CSV_RR_BATCHES of the
    epoch's 938 batches (cut) and one whole epoch through
    NativeCSVDataSetIterator, each in AsyncDataSetIterator (batches staged
    on a side stream from pinned memory), every staged batch bit-equal on
    the card to the batch numpy makes from the arrays the shards were
    written from (the CSVRecordReader route's host batches too), every
    conv launch checked, none plain, the loss falling; fit(iterator)
    images/sec eager and captured beside one resident batch's (each over
    the whole call and after the first step), the captured epoch's
    programs (2: the ragged last batch), telemetry's prefetch stalls, a
    profiled window (idle share). Leg (b), where the image decoder built: ResNet-50
    (224x224x3, 1000 classes, batch 32, Adam(1e-3)) trained from the image
    folders through AsyncImageDataSetIterator (native decode into a pinned
    ring) -> AsyncDataSetIterator, fp32 and bf16, one checked epoch each on
    one decode thread (every batch bit-equal to decode_image_file file by
    file, every launch checked), then images/sec eager and captured beside
    a resident batch's. Leg (c): the sentiment graph "last" (LSTM 300 ->
    256 on K4) trained from CSVSequenceRecordReader ->
    SequenceRecordReaderDataSetIterator (masks) -> AsyncDataSetIterator, one
    checked epoch in align_start and one in align_end, the loss falling;
    sequences/sec eager and captured beside a resident batch's.
22i. generate: the decode tier at full width. A causal BERT-base LM
    (``Bert.base(causal=True, task="mlm", max_length=512)``, random
    weights from seed 12345) behind ModelServer -> ModelRouter ->
    BatchScheduler -> ServingModel(kind="generate") -> Generator, with a
    pinned pool of 1,024 blocks of 16 (and the trash block: 16,400 slots),
    warmed (every batch bucket's prefill at each sequence bucket and its
    decode step, captured). 8 HTTP requests of 1-4 prompts (16-448 tokens,
    32-64 new), four at a time, each answer equal to the generator's own
    ``generate_full_recompute`` under the tie rule (at a first difference
    the oracle's top-two logits within 1e-4 relative, at most one row in
    32), no program built after warmup, no kernel launched; the same
    prompts through the contiguous engine, chunked prefill (64) and
    speculative decoding (the ``Bert.draft`` net, 4 tokens; a self-draft
    accepts everything), temperature samples equal paged/contiguous from
    one seed; 32 streams sharing a 256-token head through the prefix cache
    against the cacheless run (hit rate, blocks held); a pinned 8-block
    pool shedding a 429 with Retry-After, its pool conserved, the next
    request served; int8 (first-step logits within INT8_LOGIT_TOL, weight
    bytes, an int8 archive loaded with ModelRouter.load(quantize="int8"),
    its leaves bit-equal); decode tokens/sec at batch 1, 8 and 32 to 512
    tokens of context, captured and eager, time to first token at 256 and
    448, one profiled captured decode step at batch 32 (device time by
    kernel class, idle share, and the step's gathers and attentions timed
    alone), the pool's bytes. Leg serve_int8 (under
    ``capture.disabled()``): full-width ResNet-50 served over HTTP with
    ``quantize="int8"``, every K1 launch checked (53 per chunk), the
    answers within 1e-4 of the net over the dequantized leaves on the
    plain path, and the largest probability difference and top-1
    agreement against fp32 beside them.
22j. serving_resilience (under ``capture.disabled()``): full-width
    ResNet-50 behind ModelServer with a breaker on its own clock (3
    consecutive errors, 5 s cooldown), every K1 launch checked: an
    ``X-Request-Id`` echoed and found in ``debug/requests``;
    ``serving_compute_error`` on three batches opens the breaker (503 with
    ``Retry-After``) and a probe after the cooldown closes it;
    ``serving_worker_crash`` fails its batch with 500 and the restarted
    worker serves the next; ``serving_slow_batch`` (1.5 s) sheds the
    requests queued behind it past their 200 ms deadline with 429; an
    availability SLO on the model spent by those failures browns out the
    ``batch`` lane (429) while ``interactive`` serves, until
    ``slo.reset()``; ``watch`` follows the archive republished with
    ``os.replace`` as a second ResNet-50 (seed 7), then refuses a truncated
    publish and keeps version 2; ``/metrics`` holds the ``serving.*``
    families, ``/healthz`` the serving section; ``POST /admin/drain``
    finishes the requests queued behind a stalled batch and answers new
    ones 503. Every 200 answer within 1e-4 of its net on the plain path,
    53 K1 launches a chunk, none plain. Leg serving_resilience_captured:
    the worker crash with the compiled step on, no program built after
    warmup, 53 launches a chunk under replay.
22k. fleet: ``FleetRouter`` over two worker processes on the card
    (``serving/fleet_worker.py``, spec env ``DL4J_TORCH_KERNEL_IMPL=cuda``:
    a worker launches the kernel or fails the request), each serving a
    ResNet-50 archive (seed 12345) and the causal BERT-base LM's (a pinned
    pool of 256 blocks of 16, prefix cache on): each worker's time to
    ready; 16 classify requests of 1-16 rows, four at a time, within 1e-4
    of the in-process output (eager, every K1 launch checked); 16 greedy
    streams of 64-token prompts over two shared 32-token heads
    (affinity head 16), 32 new tokens each, equal to
    ``generate_full_recompute`` under the tie rule and each on
    ``rendezvous_pick``'s worker; classify rows/s straight to one worker,
    straight to two and through the router to two, and generate tokens/s
    through the router (4 closed-loop clients a worker, 3 windows of 2.5 s,
    median, min, max; each request's client wall beside the worker's
    own queue, fill and compute from its flight records); each worker's
    own K1 launches over those legs (its ``/v1/models``: 53 a chunk, none
    plain); a worker SIGKILLed under traffic (8 of
    8 answered, failovers counted), respawned into the ring (its time);
    a rolling reload to the seed-7 archive under live traffic (no answer
    but 200, versions up, answers the new net's); ``/metrics`` relabelled
    per worker; ``stop()`` drains both workers to exit code 0.
23. timing: the seconds each phase took, and the whole run's.
24. kernels: one JSON line per the kernel table in PERF.md; the conv
    kernels' entries carry LeNet's launches and step times under
    ``lenet`` and ConvLSTM2D's launches under ``launches_convlstm``, K4's
    the recurrent slice's under ``launches_recurrent_layers`` and
    ``launches_seq_graph``; every kernel's captured launches (phases
    19-22) under ``launches_captured``, the op table's (phase 18b) under
    ``launches_op_table`` with its checks under ``op_table_checked_*``,
    the SameDiff phases' (22d-22g) under ``launches_samediff`` with
    theirs under ``samediff_*checked_*``, the conv zoo's (18c) and the
    Keras import's (18d) under ``launches_conv_zoo`` and
    ``launches_keras`` with theirs under ``conv_zoo_checked`` and
    ``keras_checked`` and the depthwise times at Xception's and
    MobileNetV2's geometries under ``conv_zoo_depthwise`` and
    ``keras_depthwise``; the data pipeline's legs (22h) under
    ``launches_data_pipeline`` with theirs under
    ``data_pipeline_checked``; the int8 ResNet-50's K1 launches under
    ``launches_serve_int8`` with theirs under ``serve_int8_checked_*``,
    and the decode tier's (none) under ``launches_generate``; phase 22j's
    under ``launches_serving_resilience`` (checks
    ``serving_resilience_checked_*``) and
    ``launches_serving_resilience_captured``, phase 22k's in-process
    oracle's under ``launches_fleet_inprocess`` and each fleet worker's
    own (launches, plain calls, chunks) under ``launches_fleet_workers``.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; with no CUDA device it exits 1 before doing anything.
"""

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, dense
H100_BF16_FLOPS = 989e12      # bf16 tensor cores, dense
H100_BYTES_PER_S = 3.35e12    # HBM3
CONV_SOURCE = "deeplearning4j_tpu_torch/csrc/conv2d_fwd.cu"
CONV_REPLACES = "deeplearning4j_tpu/ops/kernels/conv.py:174"
CONV_REPLACES_TILED = "deeplearning4j_tpu/ops/kernels/conv.py:198"
WGRAD_SOURCE = "deeplearning4j_tpu_torch/csrc/conv2d_wgrad.cu"
WGRAD_REPLACES = "deeplearning4j_tpu/ops/kernels/conv.py:283"
DGRAD_REPLACES = "deeplearning4j_tpu/ops/kernels/conv.py:424"
# the conv and wgrad kernels' bodies over one bf16 ResNet-50 train step:
# wgmma for every forward conv and wgrad but the stem's (Cin 3: mma.sync)
# and for all 52 dgrads
BF16_STEP_BODIES = {"conv2d_fwd/wgmma": 52, "conv2d_fwd/mma_sync": 1,
                    "conv2d_dgrad/wgmma": 52, "conv2d_wgrad/wgmma": 52,
                    "conv2d_wgrad/mma_sync": 1}
# Gradient-kernel gates, on max|kernel - plain| / max|plain|. fp32: both sum
# up to 1e5 products (the stem's wgrad at batch 8) in fp32 in different
# orders (split slices, tap order); the rounding walk is about
# sqrt(terms) * 6e-8 of the summed magnitudes, ~1e-5 of the largest output,
# so 1e-4 leaves room and still catches a wrong term. bf16: the results are
# cast to bf16 from fp32 sums, so one differing fp32 sum can round to the
# neighbouring bf16 value: two bf16 ulps of the largest output, 2^-7.
GRAD_TOL = {"fp32": 1e-4, "bf16": 2.0 ** -7}
# train parity (auto against exact, one full-width step): the same
# arithmetic summed in other orders through 53 layers
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
SERVE_ROWS = (1, 3, 16, 2, 5, 8, 4, 7)
BUCKETS = (1, 2, 4, 8, 16, 32)
FLASH_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_fwd.cu"
FLASH_REPLACES = "deeplearning4j_tpu/ops/attention.py:119 _flash_fwd_kernel"
# Flash-attention gates, on max|kernel - plain| / max|plain| for O, and on
# the LSE's error over its largest magnitude (rows that are not fully
# masked; fully-masked rows must give -1e30 exactly). fp32: the same fp32
# arithmetic in another order over at most 512 keys, ~1e-6 of the largest
# output, so 1e-5 still catches a wrong term. bf16: the kernel rounds P to
# bf16 before P @ V (2^-9 relative per term) and both round O to bf16 (one
# ulp, 2^-8): 2^-7 of the largest output, the conv kernels' ceiling. The
# LSE is fp32 in both types (l sums the fp32 p): 1e-5.
ATTN_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
LSE_TOL = 1e-5
BERT_LAYERS = 12
# attention_kernel cases, (batch, S, head dim, mask case), 12 heads each: the
# BERT-base head geometry (D 64) at the kernel phase's batch 8; D 128 and a
# ragged S (1000: no tile divides it); the served batch (1) and the
# forward's (32) at S 512, where the bf16 body takes 64 and 128 query rows
# per block. The timed main-path case is the first (8, 512, 64, "none").
ATTENTION_CASES = (
    (8, 512, 64, "none"), (8, 512, 64, "causal"), (8, 512, 64, "padding"),
    (8, 128, 64, "none"), (8, 128, 64, "causal"), (8, 128, 64, "padding"),
    (8, 512, 128, "none"), (8, 1000, 64, "causal"), (8, 1000, 128, "padding"),
    (1, 512, 64, "none"), (32, 512, 64, "none"))
SWEEP_SEQ = (32, 64, 128, 256, 512, 1024, 2048)
# BERT-base training (bert_train): BertIterator batches of 32 at S 128 over
# the repository's own text, three epochs of fit(iterator) (66 steps).
# Adam at 1e-5 from random weights, without warmup: on this data 1e-4 and
# 3e-5 spike in the first steps and settle at the class prior (ln 2), 1e-5
# goes below it in three epochs (PERF.md, PR 10); the main path must too
BERT_TRAIN_BATCH, BERT_TRAIN_SEQ, BERT_TRAIN_EPOCHS = 32, 128, 3
BERT_TRAIN_LR = 1e-5
BERT_MLM_STEPS = BERT_TRANSFER_STEPS = 3
# the FlashAttention Function alone: (batch, S) at BERT-base's heads, each
# with no mask, causal and a padding mask with a fully-masked batch row;
# timed at batch 32
FLASH_BWD_SHAPES = ((8, 128), (8, 512), (32, 128), (32, 512))
# Its gradient gate, on max|dq, dk, dv - fp64 exact| over the largest fp64
# gradient. fp32: K5's O and LSE stand ~1e-6 from the plain path's, and the
# backward sums at most 512 keys and 64 dims in fp32 (a rounding walk of
# ~sqrt(512) * 6e-8 of the summed magnitudes), so 2e-5 still catches a
# wrong term. bf16: the inputs are the same bf16 values in both; K5 rounds
# P to bf16 before P @ V and O to bf16 (each 2^-9 relative), delta =
# sum(dO * O) takes the rounded O and feeds every ds, and each gradient is
# rounded once to bf16: four bf16 steps, 2^-6.
FLASH_BWD_TOL = {"fp32": 2e-5, "bf16": 2.0 ** -6}
LSTM_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm_cell.cu"
LSTM_SEQ_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm_seq.cu"
LSTM_REPLACES = "deeplearning4j_tpu/ops/kernels/lstm.py:97 _cell_kernel"
# LSTM cell gate, on max|kernel - plain| / max|plain| over h' and c'. fp32:
# the same fp32 sums of H products in another order (~1e-7 of the largest
# output at H = 256), so 1e-5 still catches a wrong term. bf16: both round
# the same fp32 values to bf16 once; one differing fp32 sum can land on the
# neighbouring bf16 value (2^-8): 2^-7, the other kernels' ceiling.
LSTM_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
# the char-RNN: dl4j-examples' LSTMCharModellingExample shape (batch 32,
# sequences of 1000 characters, TBPTT 50, 4 samples of 300 characters), on
# the repo's SURVEY.md mapped onto 47 symbols (anything else a space)
CHAR_SET = "abcdefghijklmnopqrstuvwxyz0123456789 \n.,:;'\"()-"
CHAR_BATCH, CHAR_SEQ, CHAR_TBPTT, CHAR_UNITS = 32, 1000, 50, 256
CHAR_FITS = 3
SAMPLES, SAMPLE_LEN, SAMPLE_PRIME = 4, 300, "the port "
# LeNet-5 (dl4j-examples' LeNetMNIST): batch 64 on the reference's
# synthetic MNIST (no idx files are in the repository), 60,000 training and
# 10,000 test digits; its two convs (5x5 VALID, stride 1) at batch 64 are
# extra cases of the kernel phases: (geometry key) -> (name, forwards,
# dgrads, wgrads per train step); conv1 reads the input, so it has no dgrad
LENET_BATCH, LENET_TRAIN, LENET_TEST = 64, 60000, 10000
LENET_CONVS = {
    (64, 28, 28, 1, 5, 5, 20, (1, 1), "VALID", (1, 1), 1): ("conv1", 1, 0, 1),
    (64, 12, 12, 20, 5, 5, 50, (1, 1), "VALID", (1, 1), 1): ("conv2", 1, 1, 1),
}
LENET_STEP = {"conv2d_fwd": 2, "conv2d_dgrad": 1, "conv2d_wgrad": 2}
LENET_ACCURACY = 0.97  # the reference's own bar (tests/test_multilayer.py)
LENET_WINDOW, LENET_SYNC_STEPS, LENET_SYNC_EVERY = 200, 200, 16
LENET_ES_TRAIN, LENET_EVAL_BATCH = 6000, 1024
# The recurrent slice. recurrent_layers: each new layer at (B, T, F) and H
# (H 256: K4's resident body for Bidirectional(LSTM)), ConvLSTM2D at B 8,
# T 10, 64x64x1 -> 64 filters, 3x3; the card against the CPU, gated on the
# error over the largest CPU value, (forward, gradients). fp32: the same
# fp32 arithmetic in other orders (K4 and the conv kernels against the
# plain step, cuBLAS against the CPU's GEMMs) through up to 20 recurrent
# steps, ~1e-6 a step: 1e-4 / 1e-3, which a wrong term (a peephole, a
# mask, a direction) exceeds. bf16: the CPU's plain step rounds every op
# to bf16 where K4 rounds its fp32 gates once a step, so the two drift
# some bf16 ulps (2^-8) apart over 20 steps: 2^-4 / 2^-3.
RL_B, RL_T, RL_F, RL_H = 16, 20, 64, 256
CONVLSTM_B, CONVLSTM_T, CONVLSTM_HW, CONVLSTM_FILTERS = 8, 10, 64, 64
LAYER_TOL = {"fp32": (1e-4, 1e-3), "bf16": (2.0 ** -4, 2.0 ** -3)}
# graves_char_rnn: dl4j-examples' GravesLSTMCharModellingExample widths;
# its rate windows are fit calls over the first 500 characters (10
# segments), half the phase's time at some 16,000 characters/sec
GRAVES_UNITS, GRAVES_RATE_SEQ = 200, 500
# seq_graph: dl4j-examples' Word2VecSentimentRNN shape (minibatch 64,
# reviews truncated at 256 steps, 300 features a step, LSTM 256, 2
# classes) on seeded reviews of 32-256 steps; two epochs over 32 batches;
# evaluate and score on the first 4, rates over windows of 3
SENT_BATCH, SENT_FEATURES, SENT_UNITS = 64, 300, 256
SENT_MIN_LEN, SENT_MAX_LEN = 32, 256
SENT_BATCHES, SENT_EPOCHS, SENT_LR = 32, 2, 5e-3
SENT_EVAL_BATCHES, SENT_WINDOW_BATCHES = 4, 3
# the graph's TBPTT and rnn_time_step against the MultiLayerNetwork's: the
# same ops in the same order on the same card
GRAPH_MLN_RTOL = 1e-6
# the compiled step (nn/capture.py): CAPTURE_STEPS steps of each path under
# the captured-against-eager gate, captured rates over RATE_WINDOWS of
# CAPTURE_WINDOW_S (the eager rates are the earlier phases'); reduced: the
# GravesLSTM gate's fit call of GRAVES_GATE_SEQ characters, LeNet's rate
# windows over LENET_CAPTURE_BATCHES batches; the sentiment graphs in
# SENT_SEQ_BUCKETS
CAPTURE_STEPS, CAPTURE_WINDOW_S = 4, 0.5
#: the eager rates' windows (count, seconds each), cut from 5 x 2 s (and
#: the captured rates' from 5 x 1 s) to keep the whole run inside its
#: limit with the serving slice's phases
RATE_WINDOWS, RATE_WINDOW_S = 3, 0.5
GRAVES_GATE_SEQ, LENET_CAPTURE_BATCHES = 200, 50
SENT_SEQ_BUCKETS = (64, 128, 192, 256)


#: every line's fields by phase, in order: the capture phases read the
#: eager phases' rates and profiles of the same run here
EMITTED = {}
#: the synthetic training digits of the lenet phase, which the
#: data_pipeline phase writes out as CSV shards (generated once a run)
DIGITS = {}


def emit(phase, **fields):
    EMITTED.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, reps=20):
    """Device milliseconds per ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events, so the host's launch overhead is
    not in the number (it is in :func:`eager_ms`)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (3 * reps)


def eager_ms(torch, fn, reps=20):
    """Milliseconds per ``fn()`` called from Python in a loop: device time
    plus whatever the host's launch path adds."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- geometries


def conv_geometries(conf, batch):
    """{(n, h, w, cin, kh, kw, cout, stride, padding, dilation, groups):
    launches per forward} for every ConvolutionLayer of a graph conf,
    walking its topological order with the layers' own shape rules."""
    from deeplearning4j_tpu_torch.nn import layers as L

    shape_of = {name: tuple(s) for name, s in zip(conf.inputs,
                                                   conf.input_shapes)}
    geoms = {}
    for n in conf.topological_order():
        ins = [shape_of[i] for i in n.inputs]
        if not n.is_layer:
            shape_of[n.name] = tuple(n.node.output_shape(*ins))
            continue
        ishape = ins[0]
        if len(ins) > 1:
            ishape = ins[0][:-1] + (sum(s[-1] for s in ins),)
        lyr = n.node
        if isinstance(lyr, L.ConvolutionLayer):
            h, w, c = ishape
            key = (batch, h, w, c, *lyr.kernel_size, lyr.n_out,
                   tuple(lyr.stride), lyr.padding, tuple(lyr.dilation), 1)
            geoms[key] = geoms.get(key, 0) + 1
        shape_of[n.name] = tuple(lyr.output_shape(ishape))
    return geoms


def read_extent(size, out, k, stride, dil, lo):
    """Input positions along one axis that some output's window reads: the
    union of the windows, clipped to the input (a 1x1/s2 window reads
    every other position; padding reads nothing)."""
    return sum(1 for i in {o * stride - lo + t * dil
                           for o in range(out) for t in range(k)}
               if 0 <= i < size)


def bound(flops, nbytes, peak_flops):
    """The least time the card could take: operations over the peak rate
    for the type, against bytes (each input element the function needs
    read once, the output written once) over the memory rate; the larger,
    and which one it is."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def check_geometry(torch, key, count):
    """The kernel against its plain version (and F.conv2d's time) at one
    geometry in fp32 and bf16; returns the per-geometry record."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    n, h, w, cin, kh, kw, cout, stride, padding, dil, groups, *rt = key
    row_tile = rt[0] if rt else None
    strides = (stride, stride) if isinstance(stride, int) else stride
    pads = kconv.resolve_padding(padding, (h, w), (kh, kw), strides, dil)
    gen = torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr(key).encode()))
    x32 = torch.randn((n, h, w, cin), generator=gen, device="cuda")
    w32 = torch.randn((kh, kw, cin // groups, cout), generator=gen,
                      device="cuda") * math.sqrt(2.0 / (kh * kw * cin))
    rec = {"geometry": {"n": n, "hw": [h, w], "cin": cin, "k": [kh, kw],
                        "cout": cout, "stride": list(strides),
                        "padding": padding, "pads": pads,
                        "dilation": list(dil), "groups": groups,
                        "row_tile": row_tile},
           "launches_per_forward": count}
    for tag, dt, peak, tol in (
            ("fp32", torch.float32, H100_FP32_FLOPS, (1e-4, 1e-4)),
            ("bf16", torch.bfloat16, H100_BF16_FLOPS, (8e-3, 1e-4))):
        x, wt = x32.to(dt), w32.to(dt)

        def kernel():
            return kconv.conv2d_fwd(x, wt, strides, pads, dil, groups,
                                    row_tile=row_tile)

        def plain():
            return kconv.conv2d_fwd_reference(x, wt, strides, pads, dil,
                                              groups)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dt:
            raise AssertionError(f"{key} {tag}: kernel gave {out.shape} "
                                 f"{out.dtype}, plain {ref.shape}")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        if not torch.isfinite(out.float()).all() or not torch.allclose(
                out.float(), ref.float(), rtol=tol[0], atol=tol[1]):
            raise AssertionError(f"{key} {tag}: kernel disagrees with the "
                                 f"plain version (max abs err {err})")
        # F.conv2d yardstick on NCHW tensors, padded once outside the timing
        # (its padding is symmetric only; SAME on the ResNet strides is not)
        xl = F.pad(x.permute(0, 3, 1, 2),
                   (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        xl = xl.contiguous()
        wl = wt.permute(3, 2, 0, 1).contiguous()
        oh, ow = out.shape[1], out.shape[2]
        flops = 2.0 * n * oh * ow * cout * kh * kw * (cin // groups)
        x_read = n * cin * read_extent(h, oh, kh, strides[0], dil[0],
                                       pads[0][0]) * read_extent(
            w, ow, kw, strides[1], dil[1], pads[1][0])
        nbytes = (x_read + wt.numel() + out.numel()) * x.element_size()
        _, splits, body = kconv.fwd_plan(x, wt, strides, pads, dil, groups,
                                         row_tile)
        rec[tag] = {
            "max_abs_err": err, "body": body, "splits": splits,
            "ms": time_ms(torch, kernel),
            "eager_ms": eager_ms(torch, kernel),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lambda: F.conv2d(
                xl, wl, None, strides, 0, dil, groups)),
            **bound(flops, nbytes, peak),
        }
    return rec


def kernel_phase(torch, conf):
    from deeplearning4j_tpu_torch.ops import kernels as kern

    geoms = conv_geometries(conf, batch=8)
    if sum(geoms.values()) != 53:
        raise AssertionError(f"ResNet-50 conf has {sum(geoms.values())} "
                             "convolutions, expected 53")
    # off the ResNet path: dilation + groups; odd channel counts with
    # anisotropic stride/dilation (the kernel's unvectorised gathers); and
    # the row-tiled program (the TPU kernel's row_tile, K2)
    extra = {(8, 29, 29, 64, 3, 3, 64, (1, 1), "SAME", (2, 2), 2): 0,
             (8, 13, 11, 6, 3, 3, 10, (2, 1), "SAME", (1, 2), 2): 0,
             (8, 56, 56, 64, 3, 3, 64, (1, 1), "SAME", (1, 1), 1, 7): 0,
             **dict.fromkeys(LENET_CONVS, 0)}
    records = []
    for key, count in list(geoms.items()) + list(extra.items()):
        rec = check_geometry(torch, key, count)
        if key in LENET_CONVS:
            rec["lenet"], rec["lenet_per_step"] = LENET_CONVS[key][:2]
        records.append(rec)
        emit("kernel", name="conv2d_fwd", **rec)
    kern.reset_counts()
    return records


# ---------------------------------------------------------- gradient kernels


def dgrad_launches(conf, batch):
    """{geometry key: dgrad launches per train step}: every conv but those
    reading the graph's input, which needs no gradient."""
    geoms = conv_geometries(conf, batch)
    from deeplearning4j_tpu_torch.nn import layers as L

    first = {(batch, *conf.input_shapes[0], *n.node.kernel_size, n.node.n_out,
              tuple(n.node.stride), n.node.padding, tuple(n.node.dilation), 1)
             for n in conf.nodes if set(n.inputs) & set(conf.inputs)
             and isinstance(n.node, L.ConvolutionLayer)}
    return {k: c - (1 if k in first else 0) for k, c in geoms.items()}


def _grad_error(out, ref):
    diff = float((out.float() - ref.float()).abs().max())
    return diff, diff / max(float(ref.float().abs().max()), 1e-30)


def check_grad_geometry(torch, key, wgrad_count, dgrad_count):
    """wgrad and dgrad kernels against their plain versions (and
    torch.nn.grad's cuDNN times) at one geometry in fp32 and bf16."""
    import torch.nn.functional as F
    from torch.nn import grad as tgrad

    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    n, h, w, cin, kh, kw, cout, stride, padding, dil, groups = key
    strides = (stride, stride) if isinstance(stride, int) else stride
    pads = kconv.resolve_padding(padding, (h, w), (kh, kw), strides, dil)
    oh = (h + sum(pads[0]) - (kh - 1) * dil[0] - 1) // strides[0] + 1
    ow = (w + sum(pads[1]) - (kw - 1) * dil[1] - 1) // strides[1] + 1
    gen = torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr(("grad", key)).encode()))
    x32 = torch.randn((n, h, w, cin), generator=gen, device="cuda")
    dy32 = torch.randn((n, oh, ow, cout), generator=gen, device="cuda")
    w32 = torch.randn((kh, kw, cin // groups, cout), generator=gen,
                      device="cuda") * math.sqrt(2.0 / (kh * kw * cin))
    rec = {"geometry": {"n": n, "hw": [h, w], "cin": cin, "k": [kh, kw],
                        "cout": cout, "stride": list(strides),
                        "padding": padding, "pads": pads,
                        "dilation": list(dil), "groups": groups},
           "wgrad_per_step": wgrad_count, "dgrad_per_step": dgrad_count}
    flops = 2.0 * n * oh * ow * cout * kh * kw * (cin // groups)
    x_read = n * cin * read_extent(h, oh, kh, strides[0], dil[0],
                                   pads[0][0]) * read_extent(
        w, ow, kw, strides[1], dil[1], pads[1][0])
    for tag, dt, peak in (("fp32", torch.float32, H100_FP32_FLOPS),
                          ("bf16", torch.bfloat16, H100_BF16_FLOPS)):
        x, dy, wt = x32.to(dt), dy32.to(dt), w32.to(dt)
        es = x.element_size()
        # NCHW, padded once outside the timing (torch.nn.grad pads
        # symmetrically only), for the cuDNN yardsticks
        xl = F.pad(x.permute(0, 3, 1, 2),
                   (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        xl = xl.contiguous()
        dyl = dy.permute(0, 3, 1, 2).contiguous()
        wl = wt.permute(3, 2, 0, 1).contiguous()
        cases = {
            "wgrad": (
                lambda: kconv.conv2d_wgrad(x, dy, kh, kw, strides, pads, dil,
                                           groups),
                lambda: kconv.conv2d_wgrad_reference(x, dy, kh, kw, strides,
                                                     pads, dil, groups),
                lambda: tgrad.conv2d_weight(xl, wl.shape, dyl, strides, 0,
                                            dil, groups),
                (x_read + dy.numel()) * es + 4 * wt.numel()),
            "dgrad": (
                lambda: kconv.conv2d_dgrad(dy, wt, (h, w), strides, pads,
                                           dil, groups),
                lambda: kconv.conv2d_dgrad_reference(dy, wt, (h, w), strides,
                                                     pads, dil, groups),
                lambda: tgrad.conv2d_input(xl.shape, wl, dyl, strides, 0,
                                           dil, groups),
                (dy.numel() + wt.numel() + x.numel()) * es),
        }
        _, dgrad_splits, dgrad_body = kconv.dgrad_plan(dy, wt, (h, w),
                                                       strides, pads, dil,
                                                       groups)
        wgrad_splits, wgrad_body = kconv.wgrad_plan(x, dy, kh, kw, strides,
                                                    pads, dil, groups)
        bodies = {"wgrad": {"body": wgrad_body, "splits": wgrad_splits},
                  "dgrad": {"body": dgrad_body, "splits": dgrad_splits,
                            "phases": [len(a[2]) for a in
                                       kconv.dgrad_phase_plan(
                                           (h, w), (kh, kw), strides, pads,
                                           dil, (oh, ow))]}}
        for kname, (kernel, plain, library, nbytes) in cases.items():
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{kname} {key} {tag}: kernel gave "
                                     f"{tuple(out.shape)}, plain "
                                     f"{tuple(ref.shape)}, or non-finite")
            err32, norm32 = _grad_error(out, ref)
            if tag == "bf16":  # as the caller sees it: in the layer's type
                err, norm = _grad_error(out.to(dt), ref.to(dt))
            else:
                err, norm = err32, norm32
            if norm > GRAD_TOL[tag]:
                raise AssertionError(
                    f"{kname} {key} {tag}: kernel disagrees with the plain "
                    f"version: max err {err} = {norm:.3g} of the largest "
                    f"output > {GRAD_TOL[tag]}")
            rec[f"{kname}_{tag}"] = {
                **bodies[kname],
                "max_abs_err": err, "max_err_normalised": norm,
                "max_err_normalised_fp32_out": norm32,
                "tolerance": GRAD_TOL[tag],
                "ms": time_ms(torch, kernel),
                "plain_ms": time_ms(torch, plain),
                "library_ms": time_ms(torch, library),
                **bound(flops, nbytes, peak)}
    return rec


def kernel_grad_phase(torch, conf):
    """The gradient kernels at every ResNet-50 conv geometry (batch 8)
    plus the dilated + grouped and odd-channel extras."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    geoms = conv_geometries(conf, batch=8)
    dg = dgrad_launches(conf, batch=8)
    if sum(dg.values()) != 52:
        raise AssertionError(f"{sum(dg.values())} dgrad launches per step, "
                             "expected 52")
    extra = {(8, 29, 29, 64, 3, 3, 64, (1, 1), "SAME", (2, 2), 2): 0,
             (8, 13, 11, 6, 3, 3, 10, (2, 1), "SAME", (1, 2), 2): 0,
             **dict.fromkeys(LENET_CONVS, 0)}
    records = []
    for key, count in list(geoms.items()) + list(extra.items()):
        rec = check_grad_geometry(torch, key, count, dg.get(key, 0))
        if key in LENET_CONVS:
            name, _, dgrads, wgrads = LENET_CONVS[key]
            rec.update(lenet=name, lenet_dgrad_per_step=dgrads,
                       lenet_wgrad_per_step=wgrads)
        records.append(rec)
        emit("kernel_grad", **rec)
    kern.reset_counts()
    return records


# ------------------------------------------------- every launch of a path


# wrapper -> plain version, in ops/kernels/conv.py and ops/kernels/attention.py
PLAIN_OF = {"conv2d_fwd": "conv2d_fwd_reference",
            "conv2d_dgrad": "conv2d_dgrad_reference",
            "conv2d_wgrad": "conv2d_wgrad_reference"}
ATTENTION_PLAIN_OF = {"flash_attention_fwd": "flash_attention_fwd_reference"}
LSTM_PLAIN_OF = {"lstm_cell_fwd": "lstm_cell_reference",
                 "lstm_seq_fwd": "lstm_seq_reference"}


def _wrapped_kernels():
    """(module, wrapper name, plain version's name) of every kernel."""
    from deeplearning4j_tpu_torch.ops.kernels import attention as katt
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv
    from deeplearning4j_tpu_torch.ops.kernels import lstm as klstm

    return ([(kconv, n, p) for n, p in PLAIN_OF.items()]
            + [(katt, n, p) for n, p in ATTENTION_PLAIN_OF.items()]
            + [(klstm, n, p) for n, p in LSTM_PLAIN_OF.items()])


def lstm_error(out, ref):
    """(max abs error, error over the largest output) of a cell's h' and c'
    (or a segment's y, carries and final state) against the plain
    version's, the worst of them."""
    errs = [_grad_error(o, r) for o, r in zip(out, ref)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def attention_error(torch, out, ref):
    """(O's max abs error, O's error over its largest value, the LSE's error
    over its largest magnitude, whether every fully-masked row gave
    exactly -1e30) of a flash result against the plain version's."""
    (o, lse), (ro, rl) = out, ref
    o_err, o_norm = _grad_error(o, ro)
    valid = rl > -1e29
    lse_norm = 0.0
    if bool(valid.any()):
        lse_norm = float((lse - rl)[valid].abs().max()) / max(
            float(rl[valid].abs().max()), 1.0)
    dead_exact = bool(((lse == rl) | valid).all())
    return o_err, o_norm, lse_norm, dead_exact


@contextlib.contextmanager
def check_every_launch(torch, checked):
    """While active, each call of a kernel's wrapper (``conv2d_fwd``,
    ``conv2d_dgrad``, ``conv2d_wgrad``, ``flash_attention_fwd``,
    ``lstm_cell_fwd``, ``lstm_seq_fwd``) is held against its plain version
    on the call's own tensors: the conv kernels by the GRAD_TOL gate on the
    error normalised by the largest plain output (bf16: on both results in
    bf16), the flash kernel by ATTN_TOL on O and LSE_TOL on the LSE, the
    LSTM cell by LSTM_TOL on h' and c', the LSTM segment by LSTM_TOL on y,
    the h and c carries and the final state. The kernel launches once per
    call, as
    unchecked, and the plain versions count nothing, so a path run under
    the check launches what it launches without it, and every one of those
    launches is checked. ``checked`` collects {(wrapper, "fp32" | "bf16"):
    {"calls", "max_err_normalised", "max_abs_err"[, "max_lse_err"]}}."""
    kernels = _wrapped_kernels()
    saved = {name: getattr(mod, name) for mod, name, _ in kernels}

    def wrap(mod, name, plain_name):
        kernel, plain = saved[name], getattr(mod, plain_name)

        def checked_call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            kwargs.pop("row_tile", None)
            kwargs.pop("body", None)
            ref = plain(*args, **kwargs)
            tag = "bf16" if args[0].dtype == torch.bfloat16 else "fp32"
            lse_err = None
            if name in ("lstm_cell_fwd", "lstm_seq_fwd"):
                if any(o.shape != r.shape or o.dtype != r.dtype
                       or not torch.isfinite(o.float()).all()
                       for o, r in zip(out, ref)):
                    raise AssertionError(f"{name} {tag}: kernel gave "
                                         f"{[tuple(o.shape) for o in out]} "
                                         "of another type, or non-finite")
                err, norm = lstm_error(out, ref)
                if norm > LSTM_TOL[tag]:
                    raise AssertionError(
                        f"{name} {tag} on the path's tensors "
                        f"{tuple(args[0].shape)} x {tuple(args[3].shape)}: "
                        f"max err {err} = {norm:.3g} of the largest output "
                        f"> {LSTM_TOL[tag]}")
            elif name == "flash_attention_fwd":
                if out[0].shape != ref[0].shape or not torch.isfinite(
                        out[0].float()).all():
                    raise AssertionError(f"{name} {tag}: kernel gave "
                                         f"{tuple(out[0].shape)} or non-finite")
                err, norm, lse_err, dead = attention_error(torch, out, ref)
                if norm > ATTN_TOL[tag] or lse_err > LSE_TOL or not dead:
                    raise AssertionError(
                        f"{name} {tag} on the path's tensors "
                        f"{tuple(args[0].shape)}: O err {norm:.3g} (gate "
                        f"{ATTN_TOL[tag]}), LSE err {lse_err:.3g} (gate "
                        f"{LSE_TOL}), fully-masked rows exact: {dead}")
            else:
                a, b = ((out, ref) if tag == "fp32" else
                        (out.to(args[0].dtype), ref.to(args[0].dtype)))
                if a.shape != b.shape or not torch.isfinite(a.float()).all():
                    raise AssertionError(f"{name} {tag}: kernel gave "
                                         f"{tuple(a.shape)}, plain "
                                         f"{tuple(b.shape)}, or non-finite")
                err, norm = _grad_error(a, b)
                if norm > GRAD_TOL[tag]:
                    raise AssertionError(
                        f"{name} {tag} on the path's tensors "
                        f"{[tuple(t.shape) for t in args[:2]]}: max err "
                        f"{err} = {norm:.3g} of the largest output > "
                        f"{GRAD_TOL[tag]}")
            rec = checked.setdefault((name, tag), {
                "calls": 0, "max_err_normalised": 0.0, "max_abs_err": 0.0})
            rec["calls"] += 1
            rec["max_err_normalised"] = max(rec["max_err_normalised"], norm)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if lse_err is not None:
                rec["max_lse_err"] = max(rec.get("max_lse_err", 0.0), lse_err)
            return out
        return checked_call

    for mod, name, plain_name in kernels:
        setattr(mod, name, wrap(mod, name, plain_name))
    try:
        yield checked
    finally:
        for mod, name, _ in kernels:
            setattr(mod, name, saved[name])


def _checked_summary(checked):
    return {f"{name}_{tag}": rec for (name, tag), rec in sorted(
        checked.items())}


# ------------------------------------------------------------------ serve


def _post(url, body):
    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def _calm_residual_branches(net, scale=0.25):
    """Scale the last batchnorm gamma of every residual branch: with random
    weights and identity running statistics each block would double the
    activations' variance and saturate the softmax; at 0.25 the 16-block
    stack stays near unit scale and the probabilities are well
    conditioned for the comparison."""
    for name, p in net.params.items():
        if name.endswith("_c_bn"):
            p["gamma"].mul_(scale)


def forward_rows_per_sec(torch, net, x, window_s=RATE_WINDOW_S,
                         windows=RATE_WINDOWS):
    """``net.output(x)`` rows/sec (no HTTP, scheduler or bucketing):
    ``windows`` windows of at least ``window_s`` seconds of back-to-back
    forwards, each closed by a device sync."""
    for _ in range(3):
        net.output(x)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            y = net.output(x)
            n += 1
        torch.cuda.synchronize()
        rates.append(x.shape[0] * n / (time.perf_counter() - t0))
    if not torch.isfinite(y.float()).all():
        raise AssertionError(f"non-finite batch-{x.shape[0]} output")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def forward_images_per_sec(torch, net, batch=32, window_s=RATE_WINDOW_S,
                           windows=RATE_WINDOWS):
    """``net.output`` forward images/sec at ``batch`` 224x224 images."""
    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    return forward_rows_per_sec(torch, net, x, window_s, windows)


def device_kernels(torch, prof):
    """[(device ms, calls, kernel name)] of a profile, largest first. A
    ``record_function`` range also shows on the device, as the span of the
    kernels inside it; those spans are left out, so the kernels' times add
    up to the device's busy time."""
    averages = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {e.key for e in averages if e.device_type != cuda}
    kernels = []
    for e in averages:
        if e.device_type != cuda or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key))
    return sorted(kernels, reverse=True)


def profile_forward(torch, net, batch=32, top=8):
    """One batch-``batch`` forward under torch.profiler: device time by
    kernel (the conv kernel and its split-K reduction apart from the
    rest), the wall time and the device's idle share of it. One warm-up
    kernel runs inside the profiler's window before the forward, and every
    kernel of the conv library must fall in a class."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    net.output(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer's warm-up kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    busy = sum(k[0] for k in kernels)
    by_class = _by_class(kernels)
    conv = by_class.get("fwd", 0.0)
    split = by_class.get("split_reduce", 0.0)
    return {"batch": batch, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "conv_kernel_ms": conv, "split_reduce_ms": split,
            "other_device_ms": busy - conv - split,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def serve_and_check(torch, np, net, model_id, input_shape, per_chunk,
                    archive=None, quantize=None, ref_net=None):
    """``net`` served over HTTP (ModelServer -> ModelRouter ->
    BatchScheduler -> ServingModel, buckets BUCKETS), or with ``archive``
    (a ModelSerializer archive of ``net``) the net ``ModelRouter.load``
    restores from it: SERVE_ROWS requests
    in two waves of four concurrent, every conv launch held against its
    plain version, ``per_chunk`` K1 launches each executed chunk, none
    plain on CUDA; the answers' probabilities within 1e-4 of the plain
    path's (of ``ref_net``'s when given: with ``quantize="int8"``, the net
    with its params set to the dequantized leaves) and their rows summing
    to 1 within 1e-5. Returns (the fields of the line, the launches, the
    checks)."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)

    t0 = time.perf_counter()
    router = ModelRouter()
    if archive is None:
        model = ServingModel(net, model_id,
                             bucketing=BucketingPolicy(batch_buckets=BUCKETS),
                             quantize=quantize)
        router.register(model, max_wait_ms=100.0, queue_limit=64)
    else:
        router.load(model_id, archive,
                    bucketing=BucketingPolicy(batch_buckets=BUCKETS),
                    quantize=quantize, max_wait_ms=100.0, queue_limit=64)
        model, _ = router.get(model_id)
    server = ModelServer(router, port=0).start()  # warms every bucket
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(12345)
    xs = [quarter_grid(np, rng, r, input_shape) for r in SERVE_ROWS]
    bodies = [{"inputs": x.tolist()} for x in xs]
    url = f"{server.url}/v1/models/{model_id}/infer"
    checked = {}
    try:
        kern.reset_counts()
        chunks0 = model.chunks_executed
        t1 = time.perf_counter()
        with check_every_launch(torch, checked), \
                ThreadPoolExecutor(4) as pool:  # two waves of 4 concurrent
            answers = list(pool.map(lambda b: _post(url, b), bodies[:4]))
            answers += list(pool.map(lambda b: _post(url, b), bodies[4:]))
        serve_s = time.perf_counter() - t1
        launches = kern.LAUNCHES["conv2d_fwd"]
        plain_on_cuda = kern.PLAIN_ON_CUDA["conv2d_fwd"]
        chunks = model.chunks_executed - chunks0
        _, sched = router.get(model_id)
        batches = sched.counts["batches"]
    finally:
        server.stop()
    if chunks < 1 or launches != per_chunk * chunks:
        raise AssertionError(f"conv kernel launched {launches} times for "
                             f"{chunks} chunks, expected {per_chunk} per "
                             "chunk")
    if plain_on_cuda:
        raise AssertionError(f"{plain_on_cuda} conv calls on CUDA tensors "
                             "took the plain path")
    if checked[("conv2d_fwd", "fp32")]["calls"] != launches:
        raise AssertionError(f"{launches} launches, "
                             f"{_checked_summary(checked)} checked")
    max_err, max_sum_err, max_prob = 0.0, 0.0, 0.0
    for x, (body, _lat) in zip(xs, answers):
        got = np.asarray(body["outputs"], np.float64)
        if got.shape != (x.shape[0], 1000) or not np.isfinite(got).all():
            raise AssertionError(f"response shape {got.shape}")
        max_sum_err = max(max_sum_err, float(np.abs(got.sum(1) - 1).max()))
        with kern.impl_scope("exact"):
            ref = (ref_net or net).output(x).double().cpu().numpy()
        max_err = max(max_err, float(np.abs(got - ref).max()))
        max_prob = max(max_prob, float(ref.max()))
    if max_sum_err > 1e-5 or max_err > 1e-4:
        raise AssertionError(f"served probabilities off: sum err "
                             f"{max_sum_err}, vs exact {max_err}")
    fields = {"requests": len(SERVE_ROWS), "rows": list(SERVE_ROWS),
              "batches": batches, "chunks": chunks,
              "conv_launches": launches, "plain_on_cuda": plain_on_cuda,
              "launches_checked": _checked_summary(checked),
              "max_abs_err_vs_exact": max_err,
              "max_row_sum_err": max_sum_err, "max_prob": max_prob,
              "warmup_s": warm_s, "serve_wall_s": serve_s,
              "served_rows_per_s": sum(SERVE_ROWS) / serve_s,
              "request_latency_s": [lat for _, lat in answers]}
    return fields, launches, checked


def serve_phase(torch, np, card):
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    fields, launches, checked = serve_and_check(torch, np, net, "resnet50",
                                                (224, 224, 3), 53)
    emit("serve", model="ResNet50", input=[224, 224, 3], classes=1000,
         params=net.num_params(), **fields, card=card)

    net16 = ResNet50(compute_dtype="bfloat16").init(device="cuda")
    net16.params, net16.states = net.params, net.states  # cast per forward
    emit("throughput", model="ResNet50", batch=32, path="net.output",
         window_s=RATE_WINDOW_S,
         forward_images_per_sec_fp32=forward_images_per_sec(
             torch, net),
         forward_images_per_sec_bf16=forward_images_per_sec(torch, net16),
         card=card)
    for tag, n in (("fp32", net), ("bf16", net16)):
        emit("profile", model="ResNet50", dtype=tag, card=card,
             **profile_forward(torch, n))
    return launches, checked


# ------------------------------------------------------------------ train


# the split-K reductions: the conv kernel's (csrc/conv2d_fwd.cu) and
# wgrad's (csrc/conv_common.cuh)
SPLIT_REDUCTIONS = ("reduce_conv_splits", "reduce_splits")


def _kernel_class(name):
    """Profile bucket of a device kernel by its name: every body of the
    conv kernel (``conv2d_fwd_f32``, ``conv2d_fwd_bf16``,
    ``conv2d_fwd_wgmma``) is "fwd", the wgrad kernel's "wgrad", the split
    reductions (SPLIT_REDUCTIONS) "split_reduce". The dgrad launches of
    the conv kernel are told from the forward's by the CPU range they run
    in (:func:`_range_kernels`), not by name."""
    if "conv2d_wgrad" in name:
        return "wgrad"
    if any(r in name for r in SPLIT_REDUCTIONS):
        return "split_reduce"
    if "conv2d_fwd" in name:
        return "fwd"
    return None


def conv_kernel_names(root=ROOT):
    """The names of the conv library's device kernels: every __global__
    function of ``deeplearning4j_tpu_torch/csrc/conv*``."""
    import glob
    import re

    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for path in glob.glob(os.path.join(root, "deeplearning4j_tpu_torch",
                                       "csrc", "conv*")):
        with open(path) as f:
            names.update(decl.findall(f.read()))
    return names


def _by_class(kernels):
    """Device ms of a profile's kernels by :func:`_kernel_class`; a kernel
    of the conv library (:func:`conv_kernel_names`) or one whose name says
    conv2d with no class fails."""
    conv_names, by_class = conv_kernel_names(), {}
    for ms, _, name in kernels:
        cls = _kernel_class(name)
        if cls:
            by_class[cls] = by_class.get(cls, 0.0) + ms
        elif "conv2d" in name or any(k in name for k in conv_names):
            raise AssertionError(f"profile: no class for kernel {name}")
    return by_class


def _range_kernels(events, name):
    """(kernel name, device us) of every device kernel launched inside the
    outermost CPU ranges whose name holds ``name``: an autograd Function
    and its backward node (``_BatchNormTrain``), or a backward node alone
    (``Conv2dFunctionBackward``). The profiler hangs a kernel on the
    innermost operator range open at its launch (a record_function range
    is not one), so a kernel launched through ctypes in a backward lands
    on that backward node."""
    def walk(evt):
        for k in evt.kernels:
            yield k.name, k.duration
        for child in evt.cpu_children:
            yield from walk(child)

    for evt in events:
        if name in evt.name and not any(name in p.name for p in
                                        _parents(evt)):
            yield from walk(evt)


# the tracer drops kernels from some eager steps (PERF.md §7): a train-step
# profile takes up to this many traces for one that holds every conv launch
PROFILE_ATTEMPTS = 6


def profile_train_step(torch, net, x, y, top=8):
    """One train step under torch.profiler: device time by kernel class
    (conv forward; dgrad = the conv kernel's launches inside the conv's
    backward node, where nothing else launches it; wgrad; the split
    reductions of all three;
    batchnorm = the kernels under the training batchnorm's autograd
    Function and its backward; other), wall time and the device's idle
    share. One warm-up kernel runs inside the profiler's window before the
    step, and every kernel of the conv library must fall in a class. The
    grouped launches of K1, dgrad and K3 (Xception's depthwise convs: the
    same kernels, so the trace cannot tell them apart) are timed by CUDA
    events around each in the same step (time_grouped_launches), a class
    of their own beside the trace's. The steps run on a copy of ``net``
    (copy_net), so the caller's state is left as it was. The tracer drops
    kernels from some eager steps (PERF.md §7; LeNet's keeps one of its
    three conv2d_fwd launches): a trace with fewer conv kernels than the
    step launched (the launch counters) is taken again, up to
    PROFILE_ATTEMPTS times, and the fullest trace with a dgrad launch
    under the conv's backward node is the one reported, with
    ``trace_complete`` false where even it lacks some conv launches (its
    device times then miss those kernels); none having one fails."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import kernels as kern

    conv = ("conv2d_fwd", "conv2d_dgrad", "conv2d_wgrad")

    def trace():
        pairs = {}
        before = sum(kern.LAUNCHES.get(k, 0) for k in conv)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the tracer can miss the first kernels after it starts: give
            # it one of its own before the step
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with time_grouped_launches(torch, pairs):
                net.fit(x, y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(torch, prof)
        traced = {}
        for _, n, name in kernels:
            cls = _kernel_class(name)
            if cls:
                traced[cls] = traced.get(cls, 0) + n
        events = prof.events()
        in_bwd = list(_range_kernels(events, "Conv2dFunctionBackward"))
        return {"pairs": pairs, "wall_ms": wall_ms, "kernels": kernels,
                "traced": traced, "events": events,
                "launched": sum(kern.LAUNCHES.get(k, 0) for k in conv)
                - before,
                "dgrad_ms": sum(us for k, us in in_bwd
                                if _kernel_class(k) == "fwd") / 1e3,
                "traced_conv": traced.get("fwd", 0) + traced.get("wgrad",
                                                                  0)}

    net = copy_net(net)
    net.fit(x, y)
    torch.cuda.synchronize()
    best, hosts = None, {}
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        t = trace()
        if t["dgrad_ms"] and (best is None
                              or t["traced_conv"] > best["traced_conv"]):
            best = t
        if not t["dgrad_ms"]:
            for evt in t["events"]:
                for k in evt.kernels:
                    if _kernel_class(k.name) == "fwd":
                        hosts[evt.name] = hosts.get(evt.name, 0) + 1
        if best is not None and best["traced_conv"] >= best["launched"]:
            break
    if best is None:
        raise AssertionError("the profile put no conv kernel under the "
                             f"conv backward nodes in {PROFILE_ATTEMPTS} "
                             f"traces; they hang on {hosts}")
    kernels, dgrad_ms = best["kernels"], best["dgrad_ms"]
    by_class = _by_class(kernels)
    busy = sum(k[0] for k in kernels)
    bn_ms = sum(us for _, us in _range_kernels(best["events"],
                                                "_BatchNormTrain")) / 1e3
    conv_like = sum(by_class.values())
    grouped = events_ms(best["pairs"])
    dw_ms = sum(ms for ms, _ in grouped.values())
    wall_ms = best["wall_ms"]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "depthwise_ms": dw_ms,
            "depthwise_share_of_busy": dw_ms / busy if busy else None,
            "depthwise_by_kernel": {k: {"ms": ms, "launches": n}
                                    for k, (ms, n) in grouped.items()},
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "fwd_ms": by_class.get("fwd", 0.0) - dgrad_ms,
            "dgrad_ms": dgrad_ms,
            "wgrad_ms": by_class.get("wgrad", 0.0),
            "split_reduce_ms": by_class.get("split_reduce", 0.0),
            "batchnorm_ms": bn_ms,
            "other_device_ms": busy - conv_like - bn_ms,
            "conv_launches_traced": best["traced"],
            "conv_launches": best["launched"], "profile_attempts": attempt,
            "trace_complete": best["traced_conv"] >= best["launched"],
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def _parents(evt):
    p = getattr(evt, "cpu_parent", None)
    while p is not None:
        yield p
        p = getattr(p, "cpu_parent", None)


def train_images_per_sec(torch, net, x, y, window_s=RATE_WINDOW_S,
                         windows=RATE_WINDOWS):
    """``net.fit`` images/sec on one device-resident batch: ``windows``
    windows of at least ``window_s`` seconds of back-to-back steps, each
    closed by a device sync; the last loss must be finite."""
    for _ in range(2):
        net.fit(x, y)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            net.fit(x, y)
            n += 1
        torch.cuda.synchronize()
        rates.append(x.shape[0] * n / (time.perf_counter() - t0))
    if not math.isfinite(net.get_score()):
        raise AssertionError(f"non-finite training loss {net.get_score()}")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def _grad_parity(g_auto, g_exact, g_64, top=8):
    """Per param tensor, the kernel path's (auto) and the plain path's
    (exact) fp32 gradients against the same step in fp64 (the plain path on
    fp64 activations). Where a gradient nearly cancels -- stem_bn's beta,
    whose shift the batch-statistic batchnorms behind the 1x1 convs absorb
    except in the windows where stem_relu / stem_pool are inactive -- both
    fp32 paths sit far from it in relative terms, so the gate on each
    tensor is: auto within TRAIN_GRAD_RTOL of the fp64 gradient, or no
    farther from it than 3x the plain path, or within 1e-6 of the largest
    tensor's gradient norm. The smoke's controls show the gate failing a
    lower-precision step. Each row's ``gate_use`` is its distance over
    the distance the gate allows it (a failure above 1). Returns (worst
    auto-vs-exact relative L2 as (name, value), the rows, the
    failures)."""
    rows = []
    for node, leaves in g_64.items():
        for k, g in leaves.items():
            g = g.double()
            a, e = g_auto[node][k].double(), g_exact[node][k].double()
            rows.append({"tensor": f"{node}.{k}",
                         "norm_fp64": float(g.norm()),
                         "auto_vs_exact_rel": float(
                             (a - e).norm() / max(float(e.norm()), 1e-30)),
                         "auto_vs_fp64": float((a - g).norm()),
                         "exact_vs_fp64": float((e - g).norm())})
    largest = max(r["norm_fp64"] for r in rows)
    for r in rows:
        r["gate_use"] = r["auto_vs_fp64"] / max(
            TRAIN_GRAD_RTOL * r["norm_fp64"], 3.0 * r["exact_vs_fp64"],
            1e-6 * largest, 1e-300)
    failures = [r for r in rows if r["gate_use"] > 1.0]
    failures.sort(key=lambda r: -r["gate_use"])
    rows.sort(key=lambda r: -r["auto_vs_exact_rel"])
    worst = (rows[0]["tensor"], rows[0]["auto_vs_exact_rel"])
    return worst, rows[:top], failures


@contextlib.contextmanager
def _wgrad_on_bf16_operands():
    """A deliberately worse wgrad for the gate's control: the kernel fed x
    and dy rounded to bf16 (8 mantissa bits), summed in fp32 as before."""
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    kernel = kconv.conv2d_wgrad
    kconv.conv2d_wgrad = lambda x, dy, *a: kernel(
        x.bfloat16().float(), dy.bfloat16().float(), *a)
    try:
        yield
    finally:
        kconv.conv2d_wgrad = kernel


def gate_controls(torch, net, x, y, g_exact, g_64):
    """The gates against steps known to be less precise than the fp32
    kernel path. (1) The plain path with TF32 matmuls (10 mantissa bits in
    every product of the step) must fail the gradient gate on some tensor.
    (2) wgrad fed bf16-rounded operands (8 mantissa bits in dW only): the
    step gate's reading is reported, and the per-launch check must stop
    it on the step's own tensors."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    def reading(g):
        (worst_name, worst), rows, failures = _grad_parity(
            g, g_exact, g_64, top=None)
        return {"tensors_failing": len(failures),
                "max_gate_use": max(r["gate_use"] for r in rows),
                "tensors": sum(len(v) for v in g_64.values()),
                "worst_vs_exact": [worst_name, worst],
                "first_failing": failures[:3]}

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with kern.impl_scope("exact"):
            g_tf32, _ = net.compute_gradient_and_score(x, y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"plain_tf32": reading(g_tf32)}
    del g_tf32
    if not out["plain_tf32"]["tensors_failing"]:
        raise AssertionError("control plain_tf32: the gradient gate passed "
                             "a TF32 step")
    with _wgrad_on_bf16_operands():
        g_bf16, _ = net.compute_gradient_and_score(x, y)
        out["wgrad_bf16_operands"] = reading(g_bf16)
        del g_bf16
        try:
            with check_every_launch(torch, {}):
                net.compute_gradient_and_score(x, y)
        except AssertionError as e:
            out["wgrad_bf16_operands"]["per_launch_check"] = str(e)[:300]
        else:
            raise AssertionError("control wgrad_bf16_operands: the "
                                 "per-launch check passed it")
    return out


def step_parity(torch, net, x, y, want, what):
    """One step's gradients under auto (its launches ``want``, none plain)
    and under exact, and the same step on fp64 activations: the loss
    within TRAIN_LOSS_RTOL and each gradient through the gate
    (_grad_parity), whose controls must fail (gate_controls). Returns the
    fields of the parity line."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    kern.reset_counts()
    g_auto, l_auto = net.compute_gradient_and_score(x, y)
    torch.cuda.synchronize()
    step_launches = conv_only(kern.LAUNCHES, want, f"{what}'s step")
    step_plain = dict(kern.PLAIN_ON_CUDA)
    if step_launches != want or any(step_plain.values()):
        raise AssertionError(f"{what}: auto step launched {step_launches} "
                             f"(expected {want}), plain on CUDA {step_plain}")
    with kern.impl_scope("exact"):
        g_exact, l_exact = net.compute_gradient_and_score(x, y)
        # the same step on fp64 activations (the entry points take fp32,
        # as the reference's do with x64 off, so this goes one level in)
        l_64, g_64, _, _ = net._gradients(
            {net.conf.inputs[0]: x.double()}, {net.conf.outputs[0]: y},
            torch.ones(x.shape[0], dtype=torch.float64, device="cuda"))
    loss_rel = abs(float(l_auto) - float(l_exact)) / abs(float(l_exact))
    (worst_name, worst), rows, failures = _grad_parity(
        g_auto, g_exact, g_64, top=None)
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"{what}: auto step off exact: loss rel "
                             f"{loss_rel}, gradients past the gate: "
                             f"{failures[:4]}")
    del g_auto
    controls = gate_controls(torch, net, x, y, g_exact, g_64)
    return {"loss_auto": float(l_auto), "loss_exact": float(l_exact),
            "loss_fp64": float(l_64), "loss_rel_err": loss_rel,
            "loss_rtol": TRAIN_LOSS_RTOL, "worst_grad": worst_name,
            "worst_grad_rel_l2": worst, "grad_rtol": TRAIN_GRAD_RTOL,
            "worst_tensors": rows[:8],
            "max_gate_use": max(r["gate_use"] for r in rows),
            "worst_gate_use": sorted(rows, key=lambda r: -r["gate_use"])[:3],
            "gate_controls": controls, "launches_per_step": step_launches,
            "plain_on_cuda": step_plain}


def checked_fit(torch, net, x, y, want, steps, what):
    """``steps`` fit steps on (x, y), every launch held against its plain
    version: ``want`` launches a step, each checked, none plain on CUDA.
    Returns (the losses, the launches, the checks)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    checked, losses = {}, []
    kern.reset_counts()
    with check_every_launch(torch, checked):
        for _ in range(steps):
            net.fit(x, y)
            losses.append(net.get_score())
    torch.cuda.synchronize()
    launches = conv_only(kern.LAUNCHES, want, f"{what}'s fit")
    plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
    if launches != {k: steps * v for k, v in want.items()} or plain:
        raise AssertionError(f"{what}: {steps} fit steps launched "
                             f"{launches}, plain on CUDA {plain}")
    if {k: checked[(k, "fp32")]["calls"] for k in want} != launches:
        raise AssertionError(f"{what}: {launches} launches, "
                             f"{_checked_summary(checked)} checked")
    return losses, launches, checked


def train_phase(torch, np, card):
    """Full-width ResNet-50 training at batch 32 (random weights from seed
    12345, random one-hot labels): auto-vs-exact step parity and the gate's
    controls; the main path (four Adam steps in fp32 through ``fit``, every
    kernel launch held against its plain version); one checked bf16 step;
    train images/sec in fp32 and bf16, and one profiled step of each."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    batch = 32
    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    labels = np.eye(1000, dtype=np.float32)[
        np.random.default_rng(12345).integers(0, 1000, batch)]
    y = torch.from_numpy(labels).cuda()

    # (a) one step's gradients under auto and under exact, same params
    want = {"conv2d_fwd": 53, "conv2d_wgrad": 53, "conv2d_dgrad": 52}
    emit("train_parity", model="ResNet50", batch=batch,
         **step_parity(torch, net, x, y, want, "ResNet-50"), card=card)

    # (b) the main path: four Adam steps through fit, each launch checked
    losses, launches, checked = checked_fit(torch, net, x, y, want, 4,
                                            "ResNet-50")
    plain = dict(kern.PLAIN_ON_CUDA)
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"Adam losses did not fall: {losses}")
    emit("train", model="ResNet50", input=[224, 224, 3], classes=1000,
         params=net.num_params(), batch=batch,
         updater=net.conf.updater, steps=4, losses=losses,
         launches=launches, plain_on_cuda=plain,
         launches_checked=_checked_summary(checked), card=card)

    # (c) one checked bf16 step, then train images/sec, fp32 and bf16
    net16 = ResNet50(compute_dtype="bfloat16").init(device="cuda")
    _calm_residual_branches(net16)
    kern.reset_counts()
    with check_every_launch(torch, checked):
        net16.fit(x, y)
    got16 = {k: checked.get((k, "bf16"), {}).get("calls") for k in want}
    if got16 != want:
        raise AssertionError(f"bf16 step checked {got16}, expected {want}")
    bodies16 = dict(kern.BODY_LAUNCHES)
    if bodies16 != BF16_STEP_BODIES:
        raise AssertionError(f"bf16 step ran the conv bodies {bodies16}, "
                             f"expected {BF16_STEP_BODIES}")
    emit("train_bf16_step", model="ResNet50", batch=batch,
         loss=net16.get_score(), launches_checked={
             f"{k}_bf16": checked[(k, "bf16")] for k in want},
         conv_bodies=bodies16, card=card)
    emit("train_throughput", model="ResNet50", batch=batch, path="net.fit",
         window_s=RATE_WINDOW_S,
         train_images_per_sec_fp32=train_images_per_sec(torch, net, x, y),
         train_images_per_sec_bf16=train_images_per_sec(torch, net16, x, y),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)

    # (d) one profiled step of each
    for tag, n in (("fp32", net), ("bf16", net16)):
        emit("train_profile", model="ResNet50", dtype=tag, batch=batch,
             card=card, **profile_train_step(torch, n, x, y))
    return launches, checked, bodies16


# ------------------------------------------------------------ attention (K5)


def attention_pairs(np, b, sq, sk, causal, mask):
    """(query, key) pairs one head attends to over the batch: every pair,
    or those inside the causal window (key <= query + Sk - Sq) and on a real
    key of the padding mask (this run's mask, so a fully-masked batch row
    needs none)."""
    real = (np.ones((b, sk)) if mask is None
            else (np.asarray(mask) > 0).astype(np.float64))
    if not causal:
        return float(sq * real.sum())
    before = np.concatenate([np.zeros((b, 1)), np.cumsum(real, axis=1)], 1)
    ends = np.clip(np.arange(sq) + (sk - sq) + 1, 0, sk)
    return float(before[:, ends].sum())


def attention_bound(np, b, h, sq, sk, d, causal, mask, es, peak):
    """The card's least time for one flash forward: 4*D operations per
    attended (query, key) pair and head (q.k and p*v, two each), against q,
    k, v read and o written once in the input type, the fp32 LSE written
    and the fp32 mask read."""
    flops = 4.0 * d * h * attention_pairs(np, b, sq, sk, causal, mask)
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * es + 4 * b * h * sq
    if mask is not None:
        nbytes += 4 * b * sk
    return bound(flops, nbytes, peak)


def attention_inputs(torch, np, b, h, s, d, seed, n=3):
    """q, k, v (and, with ``n`` 4, dO) as the encoder block hands them
    over: (B, H, S, D) views of (B, S, H, D) buffers, unit normal from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
            .cuda().permute(0, 2, 1, 3) for _ in range(n)]


def check_attention(torch, np, s, case, b=8, h=12, d=64):
    """K5 against its plain version (fp32 and bf16), with its time, the
    plain version's, SDPA's, the bound and the query rows per block the
    kernel took."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.kernels import attention as katt

    seed = zlib.crc32(repr(("attention", s, case)).encode())
    q32, k32, v32 = attention_inputs(torch, np, b, h, s, d, seed)
    mask = None
    if case == "padding":  # ragged lengths, batch row 0 fully masked
        lens = np.random.default_rng(seed).integers(s // 4, s + 1, size=b)
        lens[0] = 0
        mask = torch.from_numpy(
            (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)).cuda()
    causal = case == "causal"
    scale = d ** -0.5
    rec = {"b": b, "h": h, "s": s, "d": d, "case": case}
    for tag, dt, peak in (("fp32", torch.float32, H100_FP32_FLOPS),
                          ("bf16", torch.bfloat16, H100_BF16_FLOPS)):
        q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)

        def kernel():
            return katt.flash_attention_fwd(q, k, v, scale, causal, mask)

        def plain():
            return katt.flash_attention_fwd_reference(q, k, v, scale, causal,
                                                      mask)

        amask = None if mask is None else (mask > 0)[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=amask, is_causal=causal, scale=scale)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out[0].shape != ref[0].shape or out[0].dtype != dt \
                or not torch.isfinite(out[0].float()).all():
            raise AssertionError(f"attention {s} {case} {tag}: kernel gave "
                                 f"{tuple(out[0].shape)} {out[0].dtype}")
        err, norm, lse_err, dead = attention_error(torch, out, ref)
        if norm > ATTN_TOL[tag] or lse_err > LSE_TOL or not dead:
            raise AssertionError(
                f"attention S={s} {case} {tag}: O err {norm:.3g} (gate "
                f"{ATTN_TOL[tag]}), LSE err {lse_err:.3g} (gate {LSE_TOL}), "
                f"fully-masked rows exact: {dead}")
        rec[tag] = {
            "rows_per_block": katt.rows_per_block(q),
            "max_abs_err": err, "max_err_normalised": norm,
            "max_lse_err": lse_err, "tolerance": ATTN_TOL[tag],
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            **attention_bound(np, b, h, s, s, d, causal,
                              None if mask is None else mask.cpu().numpy(),
                              q.element_size(), peak)}
    return rec


def attention_kernel_phase(torch, np):
    """K5 on ATTENTION_CASES (no mask, causal, a padding mask with a
    fully-masked batch row); the raw launch's refusal of inputs that
    require grad, and ``flash_attention`` on such inputs giving an O with
    a grad_fn (the FlashAttention Function)."""
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.ops.kernels import attention as katt

    records = []
    for b, s, d, case in ATTENTION_CASES:
        rec = check_attention(torch, np, s, case, b=b, d=d)
        records.append(rec)
        emit("attention_kernel", name="flash_attention_fwd", **rec)
    q = torch.randn((1, 2, 32, 64), device="cuda", requires_grad=True)
    kern.reset_counts()
    try:
        katt.flash_attention_fwd(q, q, q, 0.125, False)
    except NotImplementedError as e:
        refusal = str(e)[:200]
    else:
        raise AssertionError("the raw flash launch took inputs that require "
                             "grad: its output would carry no gradient")
    o = attn.flash_attention(q, q, q, scale=0.125)
    if o.grad_fn is None or kern.LAUNCHES["flash_attention_fwd"] != 1:
        raise AssertionError(f"flash_attention on inputs that require grad "
                             f"gave grad_fn {o.grad_fn}, "
                             f"{kern.LAUNCHES['flash_attention_fwd']} K5 "
                             "launches")
    emit("attention_grad", name="flash_attention_fwd",
         raw_launch_refuses=refusal,
         flash_attention_grad_fn=type(o.grad_fn).__name__)
    kern.reset_counts()
    return records


def attention_sweep(torch, np, card):
    """The flash kernel against the port's exact ``dot_product_attention``
    from 32 to 2048 tokens, 8192 tokens per batch, 12 heads of 64, fp32 and
    bf16: the measurement ``ops/attention.py``'s FLASH_MIN_SEQ is set from
    (the shortest length from which the kernel wins at every longer one)."""
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.ops.kernels import attention as katt

    rows, crossover = [], {}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        wins = []
        for s in SWEEP_SEQ:
            b = 8192 // s
            q, k, v = (t.to(dt) for t in attention_inputs(
                torch, np, b, 12, s, 64, zlib.crc32(repr(("sweep", s))
                                                    .encode())))
            flash_ms = time_ms(torch, lambda: katt.flash_attention_fwd(
                q, k, v, 0.125, False), reps=10)
            exact_ms = time_ms(torch, lambda: attn.dot_product_attention(
                q, k, v, scale=0.125), reps=10)
            rows.append({"dtype": tag, "s": s, "batch": b,
                         "flash_ms": flash_ms, "exact_ms": exact_ms,
                         "exact_over_flash": exact_ms / flash_ms})
            wins.append((s, flash_ms < exact_ms))
            del q, k, v
        crossover[tag] = next(
            (s for i, (s, _) in enumerate(wins)
             if all(w for _, w in wins[i:])), None)
    kern.reset_counts()
    emit("attention_sweep", heads=12, head_dim=64, tokens_per_batch=8192,
         rows=rows, crossover_seq=crossover,
         port_flash_min_seq=attn.FLASH_MIN_SEQ, card=card)


# -------------------------------------------------------------------- BERT


def bert_rows(np, rows, seq, rng, dtype=None):
    """(rows, seq, 2) [token ids in [0, 30522), segment ids 0 then 1]."""
    tokens = rng.integers(0, 30522, size=(rows, seq))
    segments = np.broadcast_to(np.arange(seq) >= seq // 2, (rows, seq))
    return np.stack([tokens, segments], axis=-1).astype(dtype or np.float32)


def bert_serve_phase(torch, np, card):
    """Full-width BERT-base (seed 12345, max length 512, the flash kernel
    forced) behind ModelServer: 8 HTTP requests of 512-token rows, every
    flash launch held against the plain version on its own tensors, the
    answers against the plain path (``exact``) on the same net."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)
    from deeplearning4j_tpu_torch.zoo import Bert

    t0 = time.perf_counter()
    net = Bert.base(max_length=512, flash=True).init(device="cuda")
    n_params = net.num_params()
    model = ServingModel(net, "bert",
                         bucketing=BucketingPolicy(batch_buckets=BUCKETS))
    router = ModelRouter()
    router.register(model, max_wait_ms=100.0, queue_limit=64)
    server = ModelServer(router, port=0).start()  # warms every bucket
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(12345)
    xs = [bert_rows(np, r, 512, rng) for r in SERVE_ROWS]
    bodies = [{"inputs": x.tolist()} for x in xs]
    url = f"{server.url}/v1/models/bert/infer"
    checked = {}
    try:
        kern.reset_counts()
        chunks0 = model.chunks_executed
        t1 = time.perf_counter()
        with check_every_launch(torch, checked), \
                ThreadPoolExecutor(4) as pool:  # two waves of 4 concurrent
            answers = list(pool.map(lambda b: _post(url, b), bodies[:4]))
            answers += list(pool.map(lambda b: _post(url, b), bodies[4:]))
        serve_s = time.perf_counter() - t1
        launches = dict(kern.LAUNCHES)
        plain_on_cuda = dict(kern.PLAIN_ON_CUDA)
        chunks = model.chunks_executed - chunks0
        _, sched = router.get("bert")
        batches = sched.counts["batches"]
    finally:
        server.stop()
    flash = launches.pop("flash_attention_fwd")
    if chunks < 1 or flash != BERT_LAYERS * chunks or any(launches.values()):
        raise AssertionError(f"flash kernel launched {flash} times for "
                             f"{chunks} chunks (expected {BERT_LAYERS} per "
                             f"chunk), others {launches}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"plain path on CUDA tensors: {plain_on_cuda}")
    if checked[("flash_attention_fwd", "fp32")]["calls"] != flash:
        raise AssertionError(f"{flash} launches, "
                             f"{_checked_summary(checked)} checked")
    max_err, max_sum_err = 0.0, 0.0
    for x, (body, _lat) in zip(xs, answers):
        got = np.asarray(body["outputs"], np.float64)
        if got.shape != (x.shape[0], 2) or not np.isfinite(got).all():
            raise AssertionError(f"response shape {got.shape}")
        max_sum_err = max(max_sum_err, float(np.abs(got.sum(1) - 1).max()))
        with kern.impl_scope("exact"):
            ref = net.output(x).double().cpu().numpy()
        max_err = max(max_err, float(np.abs(got - ref).max()))
    if max_sum_err > 1e-5 or max_err > 1e-4:
        raise AssertionError(f"served probabilities off: sum err "
                             f"{max_sum_err}, vs exact {max_err}")
    emit("bert_serve", model="Bert.base", seq=512, hidden=768,
         layers=BERT_LAYERS, heads=12, ffn=3072, vocab=30522, classes=2,
         params=n_params, requests=len(SERVE_ROWS), rows=list(SERVE_ROWS),
         batches=batches, chunks=chunks, flash_launches=flash,
         plain_on_cuda=plain_on_cuda,
         launches_checked=_checked_summary(checked),
         max_abs_err_vs_exact=max_err, max_row_sum_err=max_sum_err,
         warmup_s=warm_s, serve_wall_s=serve_s,
         served_rows_per_s=sum(SERVE_ROWS) / serve_s,
         request_latency_s=[lat for _, lat in answers], card=card)
    return net, flash, checked


def _bert_class(names):
    """Profile bucket of a device kernel by the CPU ranges it ran under."""
    if "bert::layer_norm" in names:
        return "layer_norm"
    if "aten::gelu" in names:
        return "gelu"
    if names & {"aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"}:
        return "matmul"
    if names & {"aten::index_select", "aten::embedding"}:
        return "embedding_gather"
    return "other"


def profile_bert_forward(torch, net, x, top=8):
    """One ``net.output(x)`` under torch.profiler: device ms of the flash
    kernel (by name), and of the rest by the CPU range each kernel ran
    under: the projection and FFN matmuls, layer norm (a profiler range
    around ``_layer_norm`` for this run), gelu, the embedding gather;
    wall time and the device's idle share. One warm-up kernel runs inside
    the profiler's window before the forward."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeplearning4j_tpu_torch.nn import transformer as tr

    layer_norm = tr._layer_norm

    def ranged_layer_norm(*args, **kwargs):
        with record_function("bert::layer_norm"):
            return layer_norm(*args, **kwargs)

    net.output(x)
    torch.cuda.synchronize()
    tr._layer_norm = ranged_layer_norm
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the tracer can miss the first kernels after it starts: give
            # it one of its own before the forward
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.output(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tr._layer_norm = layer_norm
    kernels = device_kernels(torch, prof)
    flash_ms = sum(ms for ms, _, name in kernels if "flash_fwd" in name)
    flash_calls = sum(n for _, n, name in kernels if "flash_fwd" in name)
    busy = sum(k[0] for k in kernels)
    by_class = {}
    for evt in prof.events():
        for k in evt.kernels:
            if "flash_fwd" in k.name:
                continue
            names = {evt.name} | {p.name for p in _parents(evt)}
            cls = _bert_class(names)
            by_class[cls] = by_class.get(cls, 0.0) + k.duration / 1e3
    named = sum(v for c, v in by_class.items() if c != "other")
    return {"batch": x.shape[0], "seq": x.shape[1], "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "flash_kernel_ms": flash_ms, "flash_launches": flash_calls,
            "flash_share_of_busy": flash_ms / busy if busy else None,
            "matmul_ms": by_class.get("matmul", 0.0),
            "layer_norm_ms": by_class.get("layer_norm", 0.0),
            "gelu_ms": by_class.get("gelu", 0.0),
            "embedding_gather_ms": by_class.get("embedding_gather", 0.0),
            "other_device_ms": busy - flash_ms - named,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def bert_forward_phase(torch, np, card, net):
    """BERT-base ``net.output`` sequences/sec at batch 32, S 128 and 512,
    fp32 and bf16 (integer token ids: float ids would arrive rounded to
    bf16); one forward with a ragged padding mask in each type (the masked
    kernel variant on the main path, every launch checked; fp32 also
    against the plain path); one profiled batch-32 S=512 forward in each
    type."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.zoo import Bert

    net16 = Bert.base(max_length=512, flash=True,
                      compute_dtype="bfloat16").init(device="cuda")
    net16.params, net16.states = net.params, net.states  # cast per forward
    rng = np.random.default_rng(7)
    xs = {s: torch.from_numpy(bert_rows(np, 32, s, rng, np.int64)).cuda()
          for s in (128, 512)}
    rates = {f"seq{s}_{tag}": forward_rows_per_sec(torch, n, xs[s])
             for tag, n in (("fp32", net), ("bf16", net16))
             for s in (128, 512)}
    emit("bert_throughput", model="Bert.base", batch=32, path="net.output",
         window_s=RATE_WINDOW_S, sequences_per_sec=rates, card=card)

    lens = rng.integers(16, 513, size=32)
    lens[0] = 512
    mask = torch.from_numpy((np.arange(512)[None, :] < lens[:, None])
                            .astype(np.float32)).cuda()
    checked, masked_launches = {}, {}
    for tag, n in (("fp32", net), ("bf16", net16)):
        kern.reset_counts()
        with check_every_launch(torch, checked):
            got = n.output(xs[512], mask=mask)
        torch.cuda.synchronize()
        masked_launches[tag] = kern.LAUNCHES["flash_attention_fwd"]
        calls = checked.get(("flash_attention_fwd", tag), {}).get("calls")
        if masked_launches[tag] != BERT_LAYERS or calls != BERT_LAYERS \
                or not torch.isfinite(got.float()).all():
            raise AssertionError(f"masked {tag} forward launched "
                                 f"{masked_launches[tag]}, checked {calls}")
        if tag == "fp32":
            with kern.impl_scope("exact"):
                ref = net.output(xs[512], mask=mask)
            err = float((got.double() - ref.double()).abs().max())
            if err > 1e-4:
                raise AssertionError(f"masked forward off the plain path "
                                     f"by {err}")
    emit("bert_masked_forward", batch=32, seq=512, lengths=lens.tolist(),
         flash_launches=masked_launches,
         launches_checked=_checked_summary(checked),
         max_abs_err_vs_exact=err, card=card)
    for tag, n in (("fp32", net), ("bf16", net16)):
        prof = profile_bert_forward(torch, n, xs[512])
        if prof["flash_launches"] != BERT_LAYERS:
            raise AssertionError(f"profiled {tag} forward ran "
                                 f"{prof['flash_launches']} flash launches")
        emit("bert_profile", model="Bert.base", dtype=tag, card=card, **prof)
    return masked_launches, checked


# ------------------------------------------------------------ BERT training


def bert_corpus():
    """The training text: lines of SURVEY.md and ROADMAP.md with more than
    three words, one from each file in turn while both last; the label is
    the file a line comes from (0 SURVEY.md, 1 ROADMAP.md)."""
    def lines(name):
        with open(os.path.join(ROOT, name), encoding="utf-8") as f:
            return [ln.strip() for ln in f if len(ln.split()) > 3]

    text, labels = [], []
    for a, b in zip(lines("SURVEY.md"), lines("ROADMAP.md")):
        text += [a, b]
        labels += [0, 1]
    return text, labels


def bert_iterator(vocab, text, labels=None):
    """BertIterator over ``text`` at batch 32 and S 128: SEQ_CLASSIFICATION
    with ``labels``, else UNSUPERVISED (the 80/10/10 masker, seed
    12345)."""
    from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                              BertWordPieceTokenizer)

    task = (BertIterator.UNSUPERVISED if labels is None
            else BertIterator.SEQ_CLASSIFICATION)
    return BertIterator(BertWordPieceTokenizer(vocab), task=task,
                        max_length=BERT_TRAIN_SEQ,
                        batch_size=BERT_TRAIN_BATCH,
                        sentences=text, labels=labels,
                        n_classes=None if labels is None else 2, seed=12345)


def bert_train_net(torch, **kw):
    """Full-width BERT-base on the card, seed 12345, Adam(BERT_TRAIN_LR)."""
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import Bert

    kw.setdefault("max_length", BERT_TRAIN_SEQ)
    return Bert.base(updater=Adam(BERT_TRAIN_LR), **kw).init(device="cuda")


def _ds_on_card(torch, ds, ids_dtype=None):
    """A DataSet's arrays as card tensors; token ids as ``ids_dtype``."""
    x = torch.from_numpy(ds.features).cuda()
    if ids_dtype is not None:
        x = x.to(ids_dtype)
    return (x, torch.from_numpy(ds.labels).cuda(),
            torch.from_numpy(ds.features_mask).cuda())


def flash_bwd_bound(np, b, h, sq, sk, d, causal, mask, es, peak):
    """The card's least time for the flash backward: 10*D operations per
    attended (query, key) pair and head (the recomputed q.k, then dv, dp,
    dq and dk: 2.5x the forward's 4*D), against q, k, v, O and dO read and
    dq, dk, dv written once in the input type, the fp32 LSE read and the
    fp32 mask read."""
    flops = 10.0 * d * h * attention_pairs(np, b, sq, sk, causal, mask)
    nbytes = ((4 * b * h * sq * d + 4 * b * h * sk * d) * es
              + 4 * b * h * sq)
    if mask is not None:
        nbytes += 4 * b * sk
    return bound(flops, nbytes, peak)


def check_flash_bwd(torch, np, b, s, case, h=12, d=64, timed=False):
    """The FlashAttention Function on the card (K5's forward, the plain
    backward on its O and LSE) at BERT-base's head geometry: dq, dk, dv
    against the exact attention's autograd in fp64 on the same (rounded)
    inputs, gated by FLASH_BWD_TOL on the error over the largest fp64
    gradient; a fully-masked batch row's gradients exactly 0. With
    ``timed``: the backward's device time beside SDPA's backward and the
    exact path's autograd backward on the same inputs, each the time of
    its forward and backward in one CUDA graph less the forward's (an
    autograd backward is captured only with its forward), the Function's
    backward alone from a Python loop too (``eager_ms``), and its
    bound."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention as attn

    seed = zlib.crc32(repr(("flash_bwd", b, s, case)).encode())
    q32, k32, v32, do32 = attention_inputs(torch, np, b, h, s, d, seed, n=4)
    mask = None
    if case == "padding":  # ragged lengths, batch row 0 fully masked
        lens = np.random.default_rng(seed).integers(s // 4, s + 1, size=b)
        lens[0] = 0
        mask = torch.from_numpy(
            (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)).cuda()
    causal = case == "causal"
    amask = None if mask is None else (mask > 0)[:, None, None, :]
    rec = {"b": b, "h": h, "s": s, "d": d, "case": case}
    for tag, dt, peak in (("fp32", torch.float32, H100_FP32_FLOPS),
                          ("bf16", torch.bfloat16, H100_BF16_FLOPS)):
        q, k, v = (t.to(dt).detach().requires_grad_()
                   for t in (q32, k32, v32))
        do = do32.to(dt)
        o = attn.flash_attention(q, k, v, causal=causal, mask=mask)
        if type(o.grad_fn).__name__ != "FlashAttentionBackward":
            raise AssertionError(f"flash_attention gave grad_fn {o.grad_fn}")
        grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=timed)
        q64, k64, v64 = (t.detach().double().requires_grad_()
                         for t in (q, k, v))
        o64 = attn.dot_product_attention(q64, k64, v64, mask=amask,
                                         causal=causal)
        want = torch.autograd.grad(o64, (q64, k64, v64), do.double())
        del o64, q64, k64, v64
        errs = [float((g.double() - w).abs().max() / w.abs().max())
                for g, w in zip(grads, want)]
        dead_zero = mask is None or not any(bool(g[0].any()) for g in grads)
        if (max(errs) > FLASH_BWD_TOL[tag] or not dead_zero
                or not all(bool(torch.isfinite(g).all()) for g in grads)):
            raise AssertionError(
                f"flash backward B={b} S={s} {case} {tag}: dq/dk/dv err "
                f"{errs} of the largest fp64 gradient (gate "
                f"{FLASH_BWD_TOL[tag]}), padded row zero: {dead_zero}")
        rec[tag] = {"err_dq_dk_dv": errs, "tolerance": FLASH_BWD_TOL[tag]}
        del want
        if timed:
            # leaves of their own: a graph still holding q's gradient
            # accumulator from the default stream breaks the capture
            qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
            forwards = {
                "": lambda: attn.flash_attention(qt, kt, vt, causal=causal,
                                                 mask=mask),
                "sdpa_": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=amask, is_causal=causal,
                    scale=d ** -0.5),
                "exact_": lambda: attn.dot_product_attention(
                    qt, kt, vt, mask=amask, causal=causal)}
            for prefix, fwd in forwards.items():
                fwd_ms = time_ms(torch, fwd, reps=5)
                both_ms = time_ms(torch, lambda: torch.autograd.grad(
                    fwd(), (qt, kt, vt), do), reps=5)
                rec[tag][prefix + "fwd_bwd_ms"] = both_ms
                rec[tag][prefix + "bwd_ms"] = both_ms - fwd_ms
            rec[tag]["ms"] = rec[tag].pop("bwd_ms")
            rec[tag]["eager_ms"] = eager_ms(
                torch, lambda: torch.autograd.grad(o, (q, k, v), do,
                                                   retain_graph=True),
                reps=5)
            rec[tag]["ms_per_step"] = BERT_LAYERS * rec[tag]["ms"]
            rec[tag].update(flash_bwd_bound(
                np, b, h, s, s, d, causal,
                None if mask is None else mask.cpu().numpy(),
                q.element_size(), peak))
        del o, grads
    return rec


def _bert_train_class(kernel, names):
    """Profile bucket of a device kernel of a BERT train step: K5 by name,
    then by the CPU ranges it ran under: the FlashAttention backward node,
    Adam (a range around the updater step), layer norm's forward (a range
    around ``_layer_norm``), the matrix products, the rest."""
    if "flash_fwd" in kernel:
        return "flash_fwd"
    if any("FlashAttentionBackward" in n for n in names):
        return "flash_bwd"
    if "bert::adam" in names:
        return "adam"
    if "bert::layer_norm" in names:
        return "layer_norm_fwd"
    if names & {"aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"}:
        return "matmul"
    return "other"


def profile_bert_train_step(torch, net, x, y, mask):
    """One ``fit`` step under torch.profiler: wall time, device busy, idle
    share, and device ms by :func:`_bert_train_class` with K5's and the
    flash backward's shares of busy time. One warm-up kernel runs inside
    the profiler's window before the step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import multilayer as mln
    from deeplearning4j_tpu_torch.nn import transformer as tr

    layer_norm, step_groups = tr._layer_norm, mln.upd.step_groups

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    ds = DataSet(x, y, features_mask=mask)
    net.fit(ds)
    torch.cuda.synchronize()
    tr._layer_norm = ranged("bert::layer_norm", layer_norm)
    mln.upd.step_groups = ranged("bert::adam", step_groups)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)  # the tracer's warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tr._layer_norm, mln.upd.step_groups = layer_norm, step_groups
    kernels = device_kernels(torch, prof)
    busy = sum(k[0] for k in kernels)
    by_class, flash_launches = {}, 0
    for evt in prof.events():
        names = {evt.name} | {p.name for p in _parents(evt)}
        for k in evt.kernels:
            cls = _bert_train_class(k.name, names)
            by_class[cls] = by_class.get(cls, 0.0) + k.duration / 1e3
            flash_launches += cls == "flash_fwd"
    share = {f"{c}_share_of_busy": v / busy for c, v in by_class.items()
             if busy}
    return {"batch": x.shape[0], "seq": x.shape[1], "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "flash_launches_traced": flash_launches,
            **{f"{c}_ms": v for c, v in sorted(by_class.items())}, **share,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:8]]}


def bert_train_phase(torch, np, card):
    """BERT-base training on MultiLayerNetwork at its published width
    (hidden 768, 12 layers, 12 heads of 64, FFN 3072; seed 12345): the
    parity step, the FlashAttention Function alone at BERT-base's
    geometry, the main path (``fit(iterator)`` with dropout 0.1, every K5
    launch checked), a checked bf16 step on integer ids, masked-LM steps
    and the transfer to a frozen-embedding classifier, train
    sequences/sec, one profiled step in each type. Returns the main path's
    K5 launches, their checks (and the bf16 step's) and the Function's
    records."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nlp import Vocab
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
    from deeplearning4j_tpu_torch.nn.transformer import TimeStepLayer
    from deeplearning4j_tpu_torch.ops import kernels as kern

    flash = "flash_attention_fwd"
    text, labels = bert_corpus()
    vocab = Vocab.build(text)
    batches = list(bert_iterator(vocab, text, labels))
    steps = BERT_TRAIN_EPOCHS * len(batches)

    def flash_only(what):
        launches = dict(kern.LAUNCHES)
        n = launches.pop(flash)
        if any(launches.values()) or any(kern.PLAIN_ON_CUDA.values()):
            raise AssertionError(f"{what}: other kernels {launches}, plain "
                                 f"on CUDA {kern.PLAIN_ON_CUDA}")
        return n

    # (a) one step, auto against exact, dropout off, the same params
    net0 = bert_train_net(torch, num_classes=2, hidden_dropout=0.0)
    x, y, m = _ds_on_card(torch, batches[0])
    ones = torch.ones(x.shape[0], device="cuda")
    kern.reset_counts()
    l_auto, g_auto, _, _ = net0._gradients(None, x, y, ones, m)
    torch.cuda.synchronize()
    step_launches = flash_only("the auto step")
    if step_launches != BERT_LAYERS:
        raise AssertionError(f"auto step: {step_launches} K5 launches")
    with kern.impl_scope("exact"):
        l_exact, g_exact, _, _ = net0._gradients(None, x, y, ones, m)
        params = net0.params
        net0.params = [{k: v.double() for k, v in p.items()} for p in params]
        try:  # the same step in fp64
            l_64, g_64, _, _ = net0._gradients(None, x.double(), y.double(),
                                               ones.double(), m.double())
        finally:
            net0.params = params
    loss_rel = abs(float(l_auto) - float(l_exact)) / abs(float(l_exact))
    (worst_name, worst), rows, failures = _grad_parity(
        g_auto, g_exact, g_64, top=None)
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"BERT auto step off exact: loss rel "
                             f"{loss_rel}, gradients past the gate: "
                             f"{failures[:4]}")
    emit("bert_train_parity", model="Bert.base", batch=x.shape[0],
         seq=BERT_TRAIN_SEQ, loss_auto=float(l_auto),
         loss_exact=float(l_exact), loss_fp64=float(l_64),
         loss_rel_err=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
         worst_grad=worst_name, worst_grad_rel_l2=worst,
         max_gate_use=max(r["gate_use"] for r in rows),
         worst_gate_use=sorted(rows, key=lambda r: -r["gate_use"])[:3],
         flash_launches=step_launches, card=card)
    del net0, g_auto, g_exact, g_64

    # (b) the Function alone at BERT-base's geometry
    bwd_records = []
    for b, s in FLASH_BWD_SHAPES:
        for case in ("none", "causal", "padding"):
            rec = check_flash_bwd(torch, np, b, s, case,
                                  timed=b == BERT_TRAIN_BATCH
                                  and case == "none")
            bwd_records.append(rec)
            emit("bert_flash_backward", name="FlashAttention", **rec,
                 card=card)
    torch.cuda.empty_cache()

    # (c) the main path: fit(iterator), dropout 0.1, every K5 launch checked
    net = bert_train_net(torch, num_classes=2)
    losses = []
    inner = net._gradients

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        losses.append(out[0])
        return out

    net._gradients = recording
    checked = {}
    it = bert_iterator(vocab, text, labels)
    kern.reset_counts()
    t0 = time.perf_counter()
    try:
        with check_every_launch(torch, checked):
            net.fit(it, epochs=BERT_TRAIN_EPOCHS)
        torch.cuda.synchronize()
    finally:
        del net._gradients
    checked_s = time.perf_counter() - t0
    launches = flash_only("the BERT fit")
    losses = [float(v) for v in losses]
    first10, last10 = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if (launches != BERT_LAYERS * steps or len(losses) != steps
            or checked[(flash, "fp32")]["calls"] != launches
            or not all(math.isfinite(v) for v in losses)
            or last10 >= min(first10, math.log(2.0))):
        raise AssertionError(f"BERT fit: {launches} K5 launches over "
                             f"{len(losses)} steps, checked "
                             f"{_checked_summary(checked)}, losses {losses}")
    emit("bert_train", model="Bert.base", params=net.num_params(),
         class_prior_loss=math.log(2.0),
         hidden_dropout=0.1, updater=net.conf.updater,
         batch=BERT_TRAIN_BATCH, seq=BERT_TRAIN_SEQ, vocab=len(vocab),
         sentences=len(text), epochs=BERT_TRAIN_EPOCHS, steps=steps,
         loss_first10=first10, loss_last10=last10, losses=losses,
         launches=launches, launches_per_step=launches // steps,
         launches_checked=_checked_summary(checked),
         checked_wall_s=checked_s, card=card)
    del net
    torch.cuda.empty_cache()

    # (d) one checked bf16 step, integer token ids
    net16 = bert_train_net(torch, num_classes=2, compute_dtype="bfloat16")
    x16, y16, m16 = _ds_on_card(torch, batches[0], torch.int64)
    kern.reset_counts()
    with check_every_launch(torch, checked):
        net16.fit(DataSet(x16, y16, features_mask=m16))
    torch.cuda.synchronize()
    got16 = checked.get((flash, "bf16"), {}).get("calls")
    if flash_only("the bf16 step") != BERT_LAYERS or got16 != BERT_LAYERS \
            or not math.isfinite(net16.get_score()):
        raise AssertionError(f"bf16 step checked {got16} K5 launches, loss "
                             f"{net16.get_score()}")
    emit("bert_train_bf16", model="Bert.base", batch=x16.shape[0],
         seq=BERT_TRAIN_SEQ, loss=net16.get_score(),
         launches_checked={f"{flash}_bf16": checked[(flash, "bf16")]},
         card=card)
    del net16

    # (e) masked LM, then the transfer to a classifier on frozen embeddings
    mlm = bert_train_net(torch, task="mlm", vocab_size=len(vocab))
    mlm_checked = {}
    kern.reset_counts()
    with check_every_launch(torch, mlm_checked):
        for ds in itertools.islice(bert_iterator(vocab, text),
                                   BERT_MLM_STEPS):
            mlm.fit(ds)
            if not ds.labels_mask.any():
                raise AssertionError("an MLM batch with no masked token")
        mlm_loss = mlm.get_score()
        hs = mlm.layers[0].hidden_size
        tuned = (TransferLearning.Builder(mlm)
                 .remove_output_layer()
                 .add_layer(TimeStepLayer(index=0))
                 .add_layer(DenseLayer(n_in=hs, n_out=hs,
                                       activation="tanh"))
                 .add_layer(OutputLayer(n_in=hs, n_out=2, loss="mcxent",
                                        activation="softmax"))
                 .set_feature_extractor(0).build())
        del mlm
        frozen = {k: v.clone() for k, v in tuned.params[0].items()}
        trunk = tuned.params[1]["Wq"].clone()
        for ds in batches[:BERT_TRANSFER_STEPS]:
            tuned.fit(ds)
    torch.cuda.synchronize()
    mlm_launches = flash_only("the MLM and transfer steps")
    want = BERT_LAYERS * (BERT_MLM_STEPS + BERT_TRANSFER_STEPS)
    bit_equal = all(torch.equal(tuned.params[0][k], v)
                    for k, v in frozen.items())
    if (mlm_launches != want or not bit_equal
            or mlm_checked[(flash, "fp32")]["calls"] != want
            or torch.equal(tuned.params[1]["Wq"], trunk)
            or not math.isfinite(mlm_loss + tuned.get_score())):
        raise AssertionError(f"MLM/transfer: {mlm_launches} K5 launches "
                             f"(expected {want}), frozen bit-equal "
                             f"{bit_equal}, losses {mlm_loss} "
                             f"{tuned.get_score()}")
    emit("bert_mlm_transfer", model="Bert.base", vocab=len(vocab),
         mlm_steps=BERT_MLM_STEPS, mlm_loss=mlm_loss,
         transfer_layers=[type(lyr).__name__ for lyr in tuned.layers],
         transfer_steps=BERT_TRANSFER_STEPS, transfer_loss=tuned.get_score(),
         frozen_params_bit_equal=bit_equal, launches=mlm_launches,
         launches_checked=_checked_summary(mlm_checked), card=card)
    del tuned, frozen
    torch.cuda.empty_cache()

    # (f) train sequences/sec and one profiled step in each type
    rate_net = bert_train_net(torch, num_classes=2, max_length=512)
    rate16 = bert_train_net(torch, num_classes=2, max_length=512,
                            compute_dtype="bfloat16")
    rate16.params, rate16.states = rate_net.params, rate_net.states
    rng = np.random.default_rng(11)
    rates = {}
    for s in (128, 512):
        xs = torch.from_numpy(bert_rows(np, BERT_TRAIN_BATCH, s, rng,
                                        np.int64)).cuda()
        ys = torch.eye(2, device="cuda")[torch.from_numpy(
            rng.integers(0, 2, size=BERT_TRAIN_BATCH)).cuda()]
        for tag, n in (("fp32", rate_net), ("bf16", rate16)):
            rates[f"seq{s}_{tag}"] = train_images_per_sec(
                torch, n, xs, ys)
    emit("bert_train_throughput", model="Bert.base", batch=BERT_TRAIN_BATCH,
         path="net.fit", hidden_dropout=0.1, window_s=RATE_WINDOW_S,
         sequences_per_sec=rates,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    for tag, n in (("fp32", rate_net), ("bf16", rate16)):
        prof = profile_bert_train_step(torch, n, x16, y16, m16)
        emit("bert_train_profile", model="Bert.base", dtype=tag, card=card,
             **prof)
    kern.reset_counts()
    return launches, checked, bwd_records


# ------------------------------------------------------------ LSTM cell (K4)


def lstm_bound(b, h, es, peak):
    """The cell's bound: 2*B*H*4H operations of h @ U (the gates and the
    state update add some 20*B*H more, under 1%), against xp, h, c and U
    read once and h', c' written once."""
    nbytes = (b * 4 * h + 2 * b * h + h * 4 * h + 2 * b * h) * es
    return {"flops": 2 * b * h * 4 * h, "bytes": nbytes,
            **bound(2 * b * h * 4 * h, nbytes, peak)}


def check_lstm(torch, b, h, order_name):
    """K4 against its plain version on a strided time slice of a (B, T, 4H)
    projection, fp32 and bf16, with its time (one launch alone and 50 in one
    CUDA graph), the plain version's, the library route's (``torch.addmm``
    then ATen's fused ``_thnn_fused_lstm_cell``, gates permuted to its
    i, f, g, o order once outside the timing; a zero tensor as its hidden
    gates) and, per step of a 50-step
    segment, cuDNN's ``nn.LSTM``; and the bound."""
    from deeplearning4j_tpu_torch.ops.kernels import lstm as klstm

    order = klstm.ORDER_IFOG if order_name == "ifog" else klstm.ORDER_IOFG
    gen = torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr(("lstm", b, h, order_name)).encode()))
    xp_seq32 = torch.randn((b, 4, 4 * h), device="cuda", generator=gen)
    h32 = 0.5 * torch.randn((b, h), device="cuda", generator=gen)
    c32 = torch.randn((b, h), device="cuda", generator=gen)
    u32 = torch.randn((h, 4 * h), device="cuda", generator=gen) / h ** 0.5
    rec = {"b": b, "h": h, "order": order_name}
    for tag, dt, peak in (("fp32", torch.float32, H100_FP32_FLOPS),
                          ("bf16", torch.bfloat16, H100_BF16_FLOPS)):
        xp_seq, hh, c, u = (t.to(dt) for t in (xp_seq32, h32, c32, u32))
        xp = xp_seq[:, 2]  # (B, 4H) rows 4 * 4H apart, read in place

        def kernel():
            return klstm.lstm_cell_fwd(xp, hh, c, u, order)

        def plain():
            return klstm.lstm_cell_reference(xp, hh, c, u, order)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if any(o.shape != (b, h) or o.dtype != dt
               or not torch.isfinite(o.float()).all() for o in out):
            raise AssertionError(f"lstm B={b} H={h} {order_name} {tag}: "
                                 "kernel gave a wrong shape, type or "
                                 "non-finite values")
        err, norm = lstm_error(out, ref)
        if norm > LSTM_TOL[tag]:
            raise AssertionError(f"lstm B={b} H={h} {order_name} {tag}: err "
                                 f"{norm:.3g} > {LSTM_TOL[tag]}")
        r = {"max_abs_err": err, "max_err_normalised": norm,
             "tolerance": LSTM_TOL[tag],
             "ms": time_ms(torch, kernel, reps=50),
             "ms_one_launch": time_ms(torch, kernel, reps=1),
             "plain_ms": time_ms(torch, plain, reps=50),
             **lstm_bound(b, h, xp.element_size(), peak)}
        perm = torch.cat([torch.arange(p * h, (p + 1) * h, device="cuda")
                          for p in (order.index(g) for g in "ifgo")])
        xp_l, u_l = xp[:, perm].contiguous(), u[:, perm].contiguous()
        zeros = torch.zeros_like(xp_l)

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell(
                torch.addmm(xp_l, hh, u_l), zeros, c)[:2]

        # the yardsticks are timed only: a library call that this build of
        # torch cannot make is recorded as null with its error, not gated
        try:
            r["library_err_normalised"] = lstm_error(library(), ref)[1]
            r["library_ms"] = time_ms(torch, library, reps=50)
        except RuntimeError as e:
            r["library_ms"], r["library_error"] = None, str(e)[:200]
        if order_name == "ifog":
            try:
                cudnn = torch.nn.LSTM(h, h).to(device="cuda", dtype=dt)
                cudnn.flatten_parameters()  # one weight buffer, as cuDNN wants
                seq = torch.randn((CHAR_TBPTT, b, h), device="cuda",
                                  generator=gen).to(dt)
                state = (hh[None].contiguous(), c[None].contiguous())
                with torch.no_grad():
                    r["cudnn_lstm_ms_per_step"] = eager_ms(
                        torch, lambda: cudnn(seq, state)) / CHAR_TBPTT
            except RuntimeError as e:
                r["cudnn_lstm_ms_per_step"] = None
                r["cudnn_lstm_error"] = str(e)[:200]
        rec[tag] = r
    return rec


def lstm_seq_bound(b, h, t, es, peak, masked=False):
    """A segment's bound: 2*B*H*4H*T operations of h @ U (the gates add some
    20*B*H*T, under 1%), against U, h0, c0, xp (and the mask) read once and
    y, the c carries (and under a mask the h carries) and the final (h, c)
    written once."""
    reads = h * 4 * h + 2 * b * h + b * t * 4 * h + (b * t if masked else 0)
    writes = (3 if masked else 2) * b * t * h + 2 * b * h
    flops = 2 * b * h * 4 * h * t
    nbytes = (reads + writes) * es
    return {"flops": flops, "bytes": nbytes, **bound(flops, nbytes, peak)}


def ragged_mask(torch, b, t, gen):
    """A (B, T) 0/1 mask of random lengths from 1 to T, row 0 full."""
    lengths = torch.randint(1, t + 1, (b,), device="cuda", generator=gen)
    lengths[0] = t
    return (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()


def check_lstm_seq(torch, b, h, t, order_name):
    """The segment kernel (the main path's K4) against its plain version on a
    (B, T, 4H) projection, with and without a ragged mask, fp32 and bf16,
    on y, the carries and the final state. For IFOG also its times: the
    segment (10 launches in one CUDA graph, per launch) and per step, the
    step body forced on the same inputs, the plain version, the library
    route (``torch.addmm`` then ATen's ``_thnn_fused_lstm_cell``, gates
    permuted to its i, f, g, o order outside the timing) over the T steps
    in one CUDA graph, cuDNN ``nn.LSTM`` over the same T steps (its input
    projection included), and the bound."""
    from deeplearning4j_tpu_torch.ops.kernels import lstm as klstm

    order = klstm.ORDER_IFOG if order_name == "ifog" else klstm.ORDER_IOFG
    gen = torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr(("lstm_seq", b, h, t, order_name)).encode()))
    xp32 = torch.randn((b, t, 4 * h), device="cuda", generator=gen)
    h32 = 0.5 * torch.randn((b, h), device="cuda", generator=gen)
    c32 = torch.randn((b, h), device="cuda", generator=gen)
    u32 = torch.randn((h, 4 * h), device="cuda", generator=gen) / h ** 0.5
    mask = ragged_mask(torch, b, t, gen)
    rec = {"b": b, "h": h, "t": t, "order": order_name}
    for tag, dt, peak in (("fp32", torch.float32, H100_FP32_FLOPS),
                          ("bf16", torch.bfloat16, H100_BF16_FLOPS)):
        xp, h0, c0, u = (v.to(dt) for v in (xp32, h32, c32, u32))
        r = {"body": klstm.seq_body(dt, b, h), "tolerance": LSTM_TOL[tag]}
        for key, m in (("unmasked", None), ("masked", mask)):
            out = klstm.lstm_seq_fwd(xp, h0, c0, u, order, m)
            ref = klstm.lstm_seq_reference(xp, h0, c0, u, order, m)
            torch.cuda.synchronize()
            if any(o.shape != q.shape or o.dtype != dt
                   or not torch.isfinite(o.float()).all()
                   for o, q in zip(out, ref)):
                raise AssertionError(f"lstm_seq B={b} H={h} T={t} "
                                     f"{order_name} {tag} {key}: kernel "
                                     "gave a wrong shape, type or "
                                     "non-finite values")
            err, norm = lstm_error(out, ref)
            if norm > LSTM_TOL[tag]:
                raise AssertionError(f"lstm_seq B={b} H={h} T={t} "
                                     f"{order_name} {tag} {key}: err "
                                     f"{norm:.3g} > {LSTM_TOL[tag]}")
            r[f"max_abs_err_{key}"], r[f"max_err_normalised_{key}"] = err, norm
        r["max_abs_err"] = max(r["max_abs_err_unmasked"],
                               r["max_abs_err_masked"])
        r["max_err_normalised"] = max(r["max_err_normalised_unmasked"],
                                      r["max_err_normalised_masked"])
        if order_name == "ifog":
            r["ms"] = time_ms(torch, lambda: klstm.lstm_seq_fwd(
                xp, h0, c0, u, order), reps=10)
            r["ms_per_step"] = r["ms"] / t
            r["ms_step_body"] = time_ms(torch, lambda: klstm.lstm_seq_fwd(
                xp, h0, c0, u, order, body="step"), reps=10)
            r["plain_ms"] = time_ms(torch, lambda: klstm.lstm_seq_reference(
                xp, h0, c0, u, order), reps=2)
            r.update(lstm_seq_bound(b, h, t, xp.element_size(), peak))
            perm = torch.cat([torch.arange(p * h, (p + 1) * h, device="cuda")
                              for p in (order.index(g) for g in "ifgo")])
            xp_l, u_l = xp[:, :, perm].contiguous(), u[:, perm].contiguous()
            zeros = torch.zeros_like(xp_l[:, 0])

            def library():
                hh, cc = h0, c0
                for s in range(t):
                    hh, cc = torch.ops.aten._thnn_fused_lstm_cell(
                        torch.addmm(xp_l[:, s], hh, u_l), zeros, cc)[:2]
                return hh, cc

            # the yardsticks are timed only: a library call that this build
            # of torch cannot make is recorded as null with its error
            try:
                r["library_err_normalised"] = lstm_error(
                    library(), klstm.lstm_seq_reference(
                        xp, h0, c0, u, order)[3:])[1]
                r["library_ms"] = time_ms(torch, library, reps=1)
                r["library_ms_per_step"] = r["library_ms"] / t
            except RuntimeError as e:
                r["library_ms"], r["library_error"] = None, str(e)[:200]
            try:
                cudnn = torch.nn.LSTM(h, h, batch_first=True).to(
                    device="cuda", dtype=dt)
                cudnn.flatten_parameters()  # one weight buffer, as cuDNN wants
                seq = torch.randn((b, t, h), device="cuda",
                                  generator=gen).to(dt)
                state = (h0[None].contiguous(), c0[None].contiguous())
                with torch.no_grad():
                    r["cudnn_lstm_ms"] = eager_ms(
                        torch, lambda: cudnn(seq, state))
            except RuntimeError as e:
                r["cudnn_lstm_ms"], r["cudnn_lstm_error"] = None, str(e)[:200]
        rec[tag] = r
    return rec


def lstm_kernel_phase(torch, np):
    """K4 at the char-RNN's geometries: the one-step cell kernel at training
    (B 32, H 256) and sampling (B 4, H 256) shapes, and the segment kernel
    at a training segment (B 32, T 50) and a sampling step (B 4, T 1);
    both gate orders, fp32 and bf16. Returns (cell records, segment
    records)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    records, seq_records = [], []
    for b in (CHAR_BATCH, SAMPLES):
        for order_name in ("ifog", "iofg"):
            rec = check_lstm(torch, b, CHAR_UNITS, order_name)
            records.append(rec)
            emit("lstm_kernel", name="lstm_cell_fwd", **rec)
    for b, t in ((CHAR_BATCH, CHAR_TBPTT), (SAMPLES, 1)):
        for order_name in ("ifog", "iofg"):
            rec = check_lstm_seq(torch, b, CHAR_UNITS, t, order_name)
            seq_records.append(rec)
            emit("lstm_kernel", name="lstm_seq_fwd", **rec)
    kern.reset_counts()
    return records, seq_records


# ---------------------------------------------------------------- char-RNN


def char_corpus(np):
    """SURVEY.md, lower-cased, as indices into CHAR_SET (anything else a
    space)."""
    with open(os.path.join(ROOT, "SURVEY.md"), encoding="utf-8") as f:
        text = f.read().lower()
    lut = {ch: i for i, ch in enumerate(CHAR_SET)}
    space = lut[" "]
    return np.array([lut.get(ch, space) for ch in text], np.int64)


def char_batch(torch, np, corpus, rng, b=CHAR_BATCH, t=CHAR_SEQ):
    """(x, y) on the card: one-hot windows of ``t`` characters at offsets
    from ``rng``, and the next characters as labels."""
    starts = rng.integers(0, len(corpus) - t - 1, size=b)
    ids = torch.from_numpy(np.stack([corpus[s:s + t + 1] for s in starts]))
    eye = torch.eye(len(CHAR_SET), device="cuda")
    ids = ids.cuda()
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def char_net(dropout=0.2, dtype="float32"):
    """Full-width TextGenerationLSTM (47 characters, 256 units, the zoo's
    Adam(1e-3)), TBPTT 50, random weights from seed 12345."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(total_unique_characters=len(CHAR_SET),
                             units=CHAR_UNITS, dropout=dropout,
                             max_length=CHAR_SEQ,
                             compute_dtype=dtype).init(device="cuda")
    net.conf.tbptt_length = CHAR_TBPTT
    return net


def lstm_only(counts, what):
    """The K4 count, the segment kernel's; every other kernel's (the one-step
    cell's included) must be 0 on the char-RNN."""
    if any(v for k, v in counts.items() if k != "lstm_seq_fwd"):
        raise AssertionError(f"{what} launched {counts}")
    return counts["lstm_seq_fwd"]


def _is_k4(name):
    """A profiler kernel name of K4: the segment kernel's resident body or
    the cell kernel (its step body)."""
    return "lstm_seq_resident" in name or "lstm_cell_fwd" in name


def chars_per_sec(torch, net, x, y, windows=RATE_WINDOWS):
    """``net.fit`` characters/sec on one device-resident batch: ``windows``
    windows of one fit call each (20 TBPTT updates), each closed by a
    device sync; the loss must stay finite."""
    net.fit(x, y)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        rates.append(x.shape[0] * x.shape[1] / (time.perf_counter() - t0))
    if not math.isfinite(net.get_score()):
        raise AssertionError(f"non-finite char-RNN loss {net.get_score()}")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def profile_char_segment(torch, net, x, y, top=8):
    """One TBPTT segment's update (a 50-step fit) under torch.profiler:
    device busy, idle share, K4's launches (one per layer, by the wrapper's
    count; the trace's count beside it) and its share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import kernels as kern

    xs, ys = x[:, :CHAR_TBPTT], y[:, :CHAR_TBPTT]
    net.fit(xs, ys)
    torch.cuda.synchronize()
    kern.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernels after it starts: give it
        # one of its own before the segment
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(xs, ys)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    busy = sum(k[0] for k in kernels)
    k4 = sum(ms for ms, _, name in kernels if _is_k4(name))
    k4_calls = sum(n for _, n, name in kernels if _is_k4(name))
    return {"segment_steps": CHAR_TBPTT, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "lstm_kernel_ms": k4,
            "lstm_kernel_launches": lstm_only(dict(kern.LAUNCHES),
                                              "the profiled segment"),
            "lstm_kernel_traced_launches": k4_calls,
            "lstm_kernel_share_of_busy": k4 / busy if busy else None,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def char_rnn_train_phase(torch, np, card):
    """Full-width char-RNN training at the LSTMCharModellingExample shape:
    one segment's step under ``auto`` against ``exact`` with dropout off on
    the same params (loss, and gradients by the fp64 step gate); the main
    path, CHAR_FITS ``fit`` calls with dropout 0.2 (40 K4 launches each,
    one per segment and layer, every one held against its plain version on
    its own tensors), whose loss must fall; one checked bf16 ``fit`` call;
    train characters/sec fp32 and bf16; one profiled segment. Returns the
    net, the main path's launches, their checks and their bodies, the bf16
    net, and the train characters/sec."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    corpus = char_corpus(np)
    rng = np.random.default_rng(12345)
    batches = [char_batch(torch, np, corpus, rng) for _ in range(CHAR_FITS)]
    # two LSTM layers, one launch per TBPTT segment each
    per_fit = 2 * (CHAR_SEQ // CHAR_TBPTT)

    # (a) one segment, auto against exact, dropout off, the same params
    net0 = char_net(dropout=0.0)
    xs, ys = batches[0][0][:, :CHAR_TBPTT], batches[0][1][:, :CHAR_TBPTT]
    ones = torch.ones(CHAR_BATCH, device="cuda")
    kern.reset_counts()
    l_auto, g_auto, _, _ = net0._gradients(None, xs, ys, ones)
    torch.cuda.synchronize()
    step_launches = lstm_only(dict(kern.LAUNCHES), "the auto step")
    if step_launches != 2 or any(kern.PLAIN_ON_CUDA.values()):
        raise AssertionError(f"auto step: {step_launches} K4 launches "
                             f"(expected 2), plain on CUDA "
                             f"{kern.PLAIN_ON_CUDA}")
    with kern.impl_scope("exact"):
        l_exact, g_exact, _, _ = net0._gradients(None, xs, ys, ones)
        # the same step on fp64 activations (params cast per use)
        l_64, g_64, _, _ = net0._gradients(None, xs.double(), ys.double(),
                                           ones.double())
    loss_rel = abs(float(l_auto) - float(l_exact)) / abs(float(l_exact))
    (worst_name, worst), rows, failures = _grad_parity(
        g_auto, g_exact, g_64, top=None)
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"char-RNN auto step off exact: loss rel "
                             f"{loss_rel}, gradients past the gate: "
                             f"{failures[:4]}")
    emit("char_rnn_parity", model="TextGenerationLSTM", batch=CHAR_BATCH,
         steps=CHAR_TBPTT, loss_auto=float(l_auto),
         loss_exact=float(l_exact), loss_fp64=float(l_64),
         loss_rel_err=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
         worst_grad=worst_name, worst_grad_rel_l2=worst,
         max_gate_use=max(r["gate_use"] for r in rows),
         worst_gate_use=sorted(rows, key=lambda r: -r["gate_use"])[:3],
         launches_per_segment=step_launches, card=card)
    del net0, g_auto, g_exact, g_64

    # (b) the main path: CHAR_FITS fit calls, every K4 launch checked
    net = char_net()
    seg_losses = []
    inner = net._gradients

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seg_losses.append(out[0])
        return out

    net._gradients = recording
    checked = {}
    kern.reset_counts()
    t0 = time.perf_counter()
    try:
        with check_every_launch(torch, checked):
            for x, y in batches:
                net.fit(x, y)
        torch.cuda.synchronize()
    finally:
        del net._gradients
    checked_s = time.perf_counter() - t0
    launches = lstm_only(dict(kern.LAUNCHES), "the char-RNN fit calls")
    bodies = {k.split("/")[1]: v for k, v in kern.BODY_LAUNCHES.items()
              if k.startswith("lstm_seq_fwd/")}
    plain = dict(kern.PLAIN_ON_CUDA)
    if launches != CHAR_FITS * per_fit or any(plain.values()):
        raise AssertionError(f"{CHAR_FITS} fit calls launched K4 {launches} "
                             f"times (expected {CHAR_FITS * per_fit}), plain "
                             f"on CUDA {plain}")
    if checked[("lstm_seq_fwd", "fp32")]["calls"] != launches:
        raise AssertionError(f"{launches} launches, "
                             f"{_checked_summary(checked)} checked")
    losses = [float(v) for v in seg_losses]
    segments = CHAR_FITS * CHAR_SEQ // CHAR_TBPTT
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if (len(losses) != segments or net.iteration != segments
            or not all(math.isfinite(v) for v in losses) or last5 >= first5):
        raise AssertionError(f"char-RNN losses over {len(losses)} segments "
                             f"did not fall: {losses}")
    emit("char_rnn_train", model="TextGenerationLSTM",
         characters=len(CHAR_SET), units=CHAR_UNITS, dropout=0.2,
         params=net.num_params(), updater=net.conf.updater,
         batch=CHAR_BATCH, seq=CHAR_SEQ, tbptt=CHAR_TBPTT,
         corpus_chars=int(len(corpus)), fit_calls=CHAR_FITS,
         segments=len(losses), loss_first5=first5, loss_last5=last5,
         segment_losses=losses, launches=launches,
         launches_per_fit_call=launches // CHAR_FITS, plain_on_cuda=plain,
         bodies=bodies,
         launches_checked=_checked_summary(checked),
         checked_wall_s=checked_s, card=card)

    # (c) one checked bf16 fit call
    net16 = char_net(dtype="bfloat16")
    kern.reset_counts()
    with check_every_launch(torch, checked):
        net16.fit(*batches[0])
    torch.cuda.synchronize()
    got16 = checked.get(("lstm_seq_fwd", "bf16"), {}).get("calls")
    if got16 != per_fit or not math.isfinite(net16.get_score()):
        raise AssertionError(f"bf16 fit call checked {got16} launches "
                             f"(expected {per_fit}), loss "
                             f"{net16.get_score()}")
    emit("char_rnn_bf16_fit", model="TextGenerationLSTM", batch=CHAR_BATCH,
         seq=CHAR_SEQ, loss=net16.get_score(),
         launches_checked={"lstm_seq_fwd_bf16": checked[
             ("lstm_seq_fwd", "bf16")]}, card=card)

    # (d) train characters/sec and one profiled segment
    x, y = batches[0]
    rates = {"fp32": chars_per_sec(torch, net, x, y),
             "bf16": chars_per_sec(torch, net16, x, y)}
    emit("char_rnn_throughput", model="TextGenerationLSTM", batch=CHAR_BATCH,
         seq=CHAR_SEQ, tbptt=CHAR_TBPTT, path="net.fit",
         train_chars_per_sec_fp32=rates["fp32"],
         train_chars_per_sec_bf16=rates["bf16"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    emit("char_rnn_profile", model="TextGenerationLSTM", dtype="fp32",
         batch=CHAR_BATCH, card=card,
         **profile_char_segment(torch, net, x, y))
    kern.reset_counts()
    return net, launches, checked, bodies, net16, rates


def sample_chars(torch, np, net, rng, tol):
    """dl4j-examples' sampleCharactersFromNetwork: prime every sample with
    SAMPLE_PRIME through ``rnn_time_step``, then SAMPLE_LEN times draw each
    sample's next character from the last step's distribution (numpy
    ``rng``) and feed it back; each distribution must sum to 1 within
    ``tol``. Returns the SAMPLES strings."""
    lut = {ch: i for i, ch in enumerate(CHAR_SET)}
    eye = torch.eye(len(CHAR_SET), device="cuda")
    prime = torch.tensor([lut[ch] for ch in SAMPLE_PRIME], device="cuda")
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(eye[prime][None].expand(SAMPLES, -1, -1))
    probs = out[:, -1]
    texts = [[] for _ in range(SAMPLES)]
    for _ in range(SAMPLE_LEN):
        p = probs.double().cpu().numpy()
        if not np.isfinite(p).all() or np.abs(p.sum(1) - 1).max() > tol:
            raise AssertionError(f"sampling distribution off: {p.sum(1)}")
        nxt = [int(rng.choice(len(CHAR_SET), p=row / row.sum()))
               for row in p]
        for t, i in zip(texts, nxt):
            t.append(CHAR_SET[i])
        probs = net.rnn_time_step(eye[torch.tensor(nxt, device="cuda")])
    return [SAMPLE_PRIME + "".join(t) for t in texts]


def char_rnn_sample_phase(torch, np, card, net, net16):
    """Sampling: SAMPLES x SAMPLE_LEN characters with ``rnn_time_step`` (the
    prime one call of 9 steps, then one call a character: 2 K4 launches a
    call at batch 4, every one checked) from the fp32 net, then the same
    unchecked for characters/sec; both again from the bf16 net, whose
    distributions are bf16 (each probability within half an ulp, so the
    sum within 2^-7 of 1 where fp32's is within 1e-4). Returns the fp32
    net's launches and every check."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    want = 2 * (1 + SAMPLE_LEN)
    checked, rates = {}, {}
    for tag, n, tol in (("fp32", net, 1e-4), ("bf16", net16, 2.0 ** -7)):
        kern.reset_counts()
        with check_every_launch(torch, checked):
            texts = sample_chars(torch, np, n, np.random.default_rng(12345),
                                 tol)
        torch.cuda.synchronize()
        got = lstm_only(dict(kern.LAUNCHES), f"{tag} sampling")
        if tag == "fp32":
            launches = got
        if got != want or checked[("lstm_seq_fwd", tag)]["calls"] != want \
                or any(kern.PLAIN_ON_CUDA.values()):
            raise AssertionError(f"{tag} sampling launched K4 {got} times "
                                 f"(expected {want}), checked "
                                 f"{_checked_summary(checked)}")
        t0 = time.perf_counter()
        again = sample_chars(torch, np, n, np.random.default_rng(12345), tol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if again != texts:
            raise AssertionError(f"{tag} sampling with one seed gave two "
                                 "texts")
        rates[tag] = {"sample_wall_s": wall,
                      "chars_per_sec": SAMPLES * SAMPLE_LEN / wall,
                      "excerpt": texts[0][:60]}
    emit("char_rnn_sample", samples=SAMPLES, chars_per_sample=SAMPLE_LEN,
         prime=SAMPLE_PRIME, launches=launches,
         launches_per_char_step=(launches - 2) / SAMPLE_LEN,
         launches_checked=_checked_summary(checked),
         sample_wall_s=rates["fp32"]["sample_wall_s"],
         chars_per_sec=rates["fp32"]["chars_per_sec"],
         excerpt=rates["fp32"]["excerpt"],
         chars_per_sec_bf16=rates["bf16"]["chars_per_sec"],
         excerpt_bf16=rates["bf16"]["excerpt"], card=card)
    kern.reset_counts()
    return launches, checked


# ------------------------------------------------------------------ LeNet


def lenet_only(counts, what):
    """The conv kernels' counts; every other kernel's must be 0 on LeNet."""
    if any(v for k, v in counts.items() if k not in LENET_STEP):
        raise AssertionError(f"{what} launched {counts}")
    return {k: counts[k] for k in LENET_STEP}


def lenet_outputs(torch, net, xs, batch=LENET_BATCH):
    """``net.output`` over ``xs`` in ``evaluate``'s batches, on the host."""
    return torch.cat([net.output(xs[i:i + batch])
                      for i in range(0, len(xs), batch)]).float().cpu()


def lenet_windows(torch, net, batches, windows=RATE_WINDOWS):
    """``net.fit`` images/sec: ``windows`` windows of one fit call over the
    same LENET_WINDOW host batches (each step moves its batch to the card,
    as ``fit(iterator)`` does), each closed by a device sync."""
    net.fit(batches[:10])
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        net.fit(batches)
        torch.cuda.synchronize()
        rates.append(sum(len(ds.features) for ds in batches)
                     / (time.perf_counter() - t0))
    if not math.isfinite(net.get_score()):
        raise AssertionError(f"non-finite LeNet loss {net.get_score()}")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def lenet_phase(torch, np, card):
    """LeNet-5 (``zoo.LeNet``, seed 12345, Adam 1e-3, fp32) as
    dl4j-examples' LeNetMNIST trains it: MnistDataSetIterator at batch 64
    over the synthetic 60,000 / 10,000 digits. (a) One step under ``auto``
    against ``exact`` (the fp64 step gate), 2 / 1 / 2 conv launches. (b)
    The main path: one epoch of ``fit(iterator)`` (938 steps, the last of
    32) with ScoreIterationListener(100), PerformanceListener(100) and
    CollectScoresListener(1), every conv launch checked, none plain, every
    iteration seen once in order, the loss falling. (c) Its first
    LENET_SYNC_STEPS steps again from the same init at sync_every 16: the
    same scores. (d) ``evaluate`` on the 10,000 test digits (accuracy >=
    0.97, every row counted, the exact path's confusion matrix but for
    near-tied rows) and ``score`` against ``exact``. (e) EarlyStoppingTrainer
    on 6,000 digits. (f) A checked bf16 run of 200 steps and its
    ``evaluate``. (g) Train images/sec fp32 and bf16, ``evaluate``
    images/sec at batch 1024, one profiled step. Returns the main path's
    launches, their checks and the bf16 run's bodies."""
    import itertools

    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.data import (ArrayDataSetIterator, DataSet,
                                               MnistDataSetIterator)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import listeners as lst
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    t0 = time.perf_counter()
    train = MnistDataSetIterator(batch=LENET_BATCH, n_examples=LENET_TRAIN)
    test = MnistDataSetIterator(batch=LENET_BATCH, train=False,
                                n_examples=LENET_TEST)
    data_s = time.perf_counter() - t0
    DIGITS["train"] = (train.features, train.labels)
    steps = -(-LENET_TRAIN // LENET_BATCH)
    emit("lenet_data", synthetic=train.synthetic and test.synthetic,
         train_examples=train.total_examples(),
         test_examples=test.total_examples(), batch=LENET_BATCH,
         steps_per_epoch=steps, generate_s=data_s)
    if (train.total_examples(), test.total_examples()) != (LENET_TRAIN,
                                                           LENET_TEST):
        raise AssertionError("LeNet data: wrong example counts")

    # (a) one step, auto against exact, the same params and batch
    net0 = LeNet().init(device="cuda")
    first = next(iter(ArrayDataSetIterator(train.features, train.labels,
                                           batch=LENET_BATCH)))
    x = torch.from_numpy(first.features).cuda()
    y = torch.from_numpy(first.labels).cuda()
    ones = torch.ones(LENET_BATCH, device="cuda")
    kern.reset_counts()
    l_auto, g_auto, _, _ = net0._gradients(None, x, y, ones)
    torch.cuda.synchronize()
    step_launches = lenet_only(dict(kern.LAUNCHES), "the auto step")
    if step_launches != LENET_STEP or any(kern.PLAIN_ON_CUDA.values()):
        raise AssertionError(f"LeNet auto step launched {step_launches}, "
                             f"plain on CUDA {kern.PLAIN_ON_CUDA}")
    with kern.impl_scope("exact"):
        l_exact, g_exact, _, _ = net0._gradients(None, x, y, ones)
        l_64, g_64, _, _ = net0._gradients(None, x.double(), y.double(),
                                           ones.double())
    loss_rel = abs(float(l_auto) - float(l_exact)) / abs(float(l_exact))
    (worst_name, worst), rows, failures = _grad_parity(
        g_auto, g_exact, g_64, top=None)
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"LeNet auto step off exact: loss rel "
                             f"{loss_rel}, gradients past the gate: "
                             f"{failures[:4]}")
    emit("lenet_parity", model="LeNet", batch=LENET_BATCH,
         loss_auto=float(l_auto), loss_exact=float(l_exact),
         loss_fp64=float(l_64), loss_rel_err=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, worst_grad=worst_name,
         worst_grad_rel_l2=worst, grad_rtol=TRAIN_GRAD_RTOL,
         max_gate_use=max(r["gate_use"] for r in rows),
         worst_gate_use=sorted(rows, key=lambda r: -r["gate_use"])[:3],
         launches_per_step=step_launches, card=card)
    del net0, g_auto, g_exact, g_64

    # (b) the main path: one epoch of fit(iterator) with listeners
    net = LeNet().init(device="cuda")
    logs = {"score": [], "perf": []}
    collect = lst.CollectScoresListener(1)
    net.set_listeners(lst.ScoreIterationListener(100, log_fn=logs["score"]
                                                 .append),
                      lst.PerformanceListener(100, log_fn=logs["perf"]
                                              .append), collect)
    checked = {}
    kern.reset_counts()
    t0 = time.perf_counter()
    with check_every_launch(torch, checked):
        net.fit(train)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = lenet_only(dict(kern.LAUNCHES), "the LeNet epoch")
    plain = dict(kern.PLAIN_ON_CUDA)
    if launches != {k: v * steps for k, v in LENET_STEP.items()} or any(
            plain.values()):
        raise AssertionError(f"the LeNet epoch launched {launches} "
                             f"({steps} steps), plain on CUDA {plain}")
    if {k: checked[(k, "fp32")]["calls"] for k in LENET_STEP} != launches:
        raise AssertionError(f"{launches} launches, "
                             f"{_checked_summary(checked)} checked")
    its = [it for it, _ in collect.scores]
    scores = [v for _, v in collect.scores]
    first50, last50 = sum(scores[:50]) / 50, sum(scores[-50:]) / 50
    if its != list(range(1, steps + 1)) or net.iteration != steps:
        raise AssertionError(f"the listener saw iterations {its[:5]}... "
                             f"({len(its)}), expected 1..{steps}")
    if not all(math.isfinite(v) for v in scores) or last50 >= first50:
        raise AssertionError(f"LeNet loss did not fall: first 50 mean "
                             f"{first50}, last 50 {last50}")
    emit("lenet_train", model="LeNet", params=net.num_params(),
         updater=net.conf.updater, batch=LENET_BATCH, steps=steps,
         epochs=net.epoch, loss_first50=first50, loss_last50=last50,
         launches=launches, plain_on_cuda=plain,
         launches_checked=_checked_summary(checked), checked_epoch_s=epoch_s,
         score_log=logs["score"], performance_log=logs["perf"], card=card)

    # (c) the first LENET_SYNC_STEPS steps again at sync_every 16
    conf = LeNet().conf()
    conf.knobs["sync_every"] = LENET_SYNC_EVERY
    net_sync = MultiLayerNetwork(conf).init(device="cuda")
    collect16 = lst.CollectScoresListener(1)
    net_sync.set_listeners(collect16)
    again = ArrayDataSetIterator(train.features, train.labels,
                                 batch=LENET_BATCH, shuffle=True,
                                 seed=train.seed)
    net_sync.fit(list(itertools.islice(iter(again), LENET_SYNC_STEPS)))
    torch.cuda.synchronize()
    pairs = list(zip(collect.scores[:LENET_SYNC_STEPS], collect16.scores))
    diff = max(abs(a[1] - b[1]) / max(abs(a[1]), 1e-30) for a, b in pairs)
    fetches = net_sync._dispatcher.fetches
    if (len(collect16.scores) != LENET_SYNC_STEPS or diff > 1e-6
            or any(a[0] != b[0] for a, b in pairs)
            or fetches != -(-LENET_SYNC_STEPS // LENET_SYNC_EVERY)):
        raise AssertionError(f"sync_every {LENET_SYNC_EVERY}: "
                             f"{len(collect16.scores)} scores, largest "
                             f"relative difference {diff}, {fetches} "
                             "fetches")
    emit("lenet_sync_every", sync_every=LENET_SYNC_EVERY,
         steps=LENET_SYNC_STEPS, host_fetches=fetches,
         max_rel_diff_vs_sync_every_1=diff, card=card)
    del net_sync

    # (d) evaluate and score on the 10,000 test digits, auto against exact
    kern.reset_counts()
    ev = net.evaluate(test)
    p_auto = lenet_outputs(torch, net, test.features)
    with kern.impl_scope("exact"):
        ev_exact = net.evaluate(test)
        p_exact = lenet_outputs(torch, net, test.features)
    top2 = p_exact.topk(2, dim=1).values
    tied = (top2[:, 0] - top2[:, 1]) <= 1e-4
    a_auto, a_exact = p_auto.argmax(1), p_exact.argmax(1)
    truth = torch.from_numpy(test.labels).argmax(1)

    def confusion(pred):
        c = torch.zeros((10, 10), dtype=torch.int64)
        c.index_put_((truth, pred), torch.ones_like(truth), accumulate=True)
        return c.numpy()

    counted = int(ev.confusion_matrix().sum())
    if (counted != LENET_TEST or ev.accuracy() < LENET_ACCURACY
            or not (a_auto[~tied] == a_exact[~tied]).all()
            or (ev.confusion_matrix() != confusion(a_auto)).any()
            or (ev_exact.confusion_matrix() != confusion(a_exact)).any()):
        raise AssertionError(f"LeNet evaluate: {counted} rows, accuracy "
                             f"{ev.accuracy()} (bar {LENET_ACCURACY}), "
                             f"{int(tied.sum())} near-tied rows, auto and "
                             f"exact argmax differ on "
                             f"{int((a_auto != a_exact).sum())}")
    whole = DataSet(test.features, test.labels)
    s_auto = net.score(whole)
    with kern.impl_scope("exact"):
        s_exact = net.score(whole)
    score_rel = abs(s_auto - s_exact) / abs(s_exact)
    if score_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"LeNet score: auto {s_auto}, exact {s_exact}")
    emit("lenet_evaluate", examples=counted, accuracy=ev.accuracy(),
         accuracy_bar=LENET_ACCURACY, accuracy_exact=ev_exact.accuracy(),
         f1=ev.f1(), near_tied_rows=int(tied.sum()),
         argmax_differs=int((a_auto != a_exact).sum()),
         score_auto=s_auto, score_exact=s_exact, score_rel_err=score_rel,
         confusion=ev.confusion_matrix().tolist(), card=card)

    # (e) early stopping on 6,000 training digits
    small = ArrayDataSetIterator(train.features[:LENET_ES_TRAIN],
                                 train.labels[:LENET_ES_TRAIN],
                                 batch=LENET_BATCH, shuffle=True, seed=7)
    cfg = (es.EarlyStoppingConfiguration.builder()
           .score_calculator(es.DataSetLossCalculator(test))
           .model_saver(es.InMemoryModelSaver())
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(3),
               es.ScoreImprovementEpochTerminationCondition(1)).build())
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, LeNet().init(device="cuda"),
                                     small).fit()
    es_s = time.perf_counter() - t0
    best = result.best_model
    rescored = es.DataSetLossCalculator(test).calculate_score(best)
    on_cuda = all(t.is_cuda for p in best.params for t in p.values())
    if (abs(rescored - result.best_model_score)
            > 1e-6 * abs(result.best_model_score) or not on_cuda):
        raise AssertionError(f"early stopping: best model rescored "
                             f"{rescored}, recorded "
                             f"{result.best_model_score}, params on CUDA "
                             f"{on_cuda}")
    emit("lenet_early_stopping", train_examples=LENET_ES_TRAIN,
         reason=result.termination_reason.value,
         details=result.termination_details,
         total_epochs=result.total_epochs,
         best_epoch=result.best_model_epoch,
         best_score=result.best_model_score, rescored=rescored,
         score_vs_epoch=result.score_vs_epoch, wall_s=es_s, card=card)
    del best, result

    # (f) a checked bf16 run of LENET_WINDOW steps, then its evaluate
    batches = list(itertools.islice(iter(ArrayDataSetIterator(
        train.features, train.labels, batch=LENET_BATCH, shuffle=True,
        seed=train.seed)), LENET_WINDOW))
    net16 = LeNet(compute_dtype="bfloat16").init(device="cuda")
    kern.reset_counts()
    with check_every_launch(torch, checked):
        net16.fit(batches)
    torch.cuda.synchronize()
    want16 = {k: v * LENET_WINDOW for k, v in LENET_STEP.items()}
    got16 = {k: checked.get((k, "bf16"), {}).get("calls") for k in LENET_STEP}
    bodies16 = dict(kern.BODY_LAUNCHES)
    if got16 != want16 or bodies16 != {f"{k}/mma_sync": v
                                       for k, v in want16.items()}:
        raise AssertionError(f"bf16 LeNet run checked {got16}, bodies "
                             f"{bodies16}, expected {want16} on mma_sync")
    ev16 = net16.evaluate(test)
    if int(ev16.confusion_matrix().sum()) != LENET_TEST:
        raise AssertionError("bf16 LeNet evaluate lost rows")
    emit("lenet_bf16", steps=LENET_WINDOW, loss=net16.get_score(),
         accuracy=ev16.accuracy(), conv_bodies=bodies16,
         launches_checked={f"{k}_bf16": checked[(k, "bf16")]
                           for k in LENET_STEP}, card=card)

    # (g) rates and one profiled step
    rates = {"train_images_per_sec_fp32": lenet_windows(torch, net, batches),
             "train_images_per_sec_bf16": lenet_windows(torch, net16,
                                                        batches)}
    big = ArrayDataSetIterator(test.features, test.labels,
                               batch=LENET_EVAL_BATCH)
    for tag, n in (("fp32", net), ("bf16", net16)):
        n.evaluate(big)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            n.evaluate(big)
            walls.append(time.perf_counter() - t0)
        walls.sort()
        rates[f"evaluate_images_per_sec_{tag}"] = {
            "median": LENET_TEST / walls[2], "min": LENET_TEST / walls[-1],
            "max": LENET_TEST / walls[0], "batch": LENET_EVAL_BATCH}
    emit("lenet_throughput", model="LeNet", batch=LENET_BATCH,
         window_steps=LENET_WINDOW, path="net.fit / net.evaluate",
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card,
         **rates)
    for tag, n in (("fp32", net), ("bf16", net16)):
        prof = profile_train_step(torch, n, x, y)
        conv = (prof["fwd_ms"] + prof["dgrad_ms"] + prof["wgrad_ms"]
                + prof["split_reduce_ms"])
        # the trace's conv launches beside the wrappers' (fwd counts the
        # forwards and the dgrad: one kernel), as the trace can drop some
        emit("lenet_profile", model="LeNet", dtype=tag, batch=LENET_BATCH,
             conv_kernel_ms=conv,
             conv_share_of_busy=conv / prof["device_busy_ms"],
             conv_launches_per_step={"fwd": 3, "wgrad": 2}, card=card,
             **prof)
    kern.reset_counts()
    return launches, checked, bodies16


# ---------------------------------------------------- the recurrent slice


def _flat_grads(grads):
    """{node: {"a/b": tensor}} of a graph's or network's nested gradients,
    for :func:`_grad_parity`."""
    from deeplearning4j_tpu_torch.tree import tree_items

    return {node: {"/".join(map(str, path)): g
                   for path, g in tree_items(tree)}
            for node, tree in grads.items()}


@contextlib.contextmanager
def recording_losses(net):
    """While active, each training step's loss (what the net's
    ``_gradients`` returns) is appended to the yielded list."""
    losses, inner = [], net._gradients

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        losses.append(out[0])
        return out

    net._gradients = recording
    try:
        yield losses
    finally:
        del net._gradients


def step_against_exact(torch, net, args, args64, after_auto):
    """One training step's loss and gradients under ``auto`` against
    ``exact`` on the same params, and the same step on fp64 activations
    (``args64``), by TRAIN_LOSS_RTOL and the gate of :func:`_grad_parity`;
    ``after_auto()`` checks the auto step's launches before ``exact`` adds
    its plain calls. Returns the line's fields."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    kern.reset_counts()
    l_auto, g_auto, _, _ = net._gradients(*args)
    torch.cuda.synchronize()
    after_auto()
    with kern.impl_scope("exact"):
        l_exact, g_exact, _, _ = net._gradients(*args)
        l_64, g_64, _, _ = net._gradients(*args64)
    loss_rel = abs(float(l_auto) - float(l_exact)) / abs(float(l_exact))
    (worst_name, worst), _, failures = _grad_parity(
        _flat_grads(g_auto), _flat_grads(g_exact), _flat_grads(g_64))
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"step off exact: loss rel {loss_rel}, "
                             f"gradients past the gate {failures[:4]}")
    return {"step_loss_auto": float(l_auto), "step_loss_exact":
            float(l_exact), "step_loss_fp64": float(l_64),
            "step_loss_rel_err": loss_rel, "worst_grad": worst_name,
            "worst_grad_rel_l2": worst}


def recurrent_cases(torch):
    """(name, layer, input shape, run) of each layer, wrapper, head and
    vertex the recurrent_layers phase holds on the card against the CPU;
    ``run(layer, params, x, mask)`` gives the output to compare."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import recurrent as R
    from deeplearning4j_tpu_torch.nn import vertices as V

    seq = (RL_B, RL_T, RL_F)
    img = (CONVLSTM_B, CONVLSTM_T, CONVLSTM_HW, CONVLSTM_HW, 1)

    def apply(layer, p, x, m):
        return layer.apply(p, {}, x, mask=m)[0]

    def rnn_loss(layer, p, x, m):
        labels = torch.eye(RL_F, device=x.device, dtype=x.dtype)[
            torch.arange(RL_B * RL_T, device=x.device).reshape(RL_B, RL_T)
            % RL_F]
        weights = torch.linspace(1.0, 0.0, RL_B, device=x.device)
        return layer.compute_loss(p, {}, x, labels, weights=weights, mask=m)

    cases = [
        ("GravesLSTM", R.GravesLSTM(n_in=RL_F, n_out=RL_H), seq, apply),
        ("GRU", R.GRU(n_in=RL_F, n_out=RL_H), seq, apply),
        ("GRU_b_rec", R.GRU(n_in=RL_F, n_out=RL_H, recurrent_bias=True), seq,
         apply),
        ("SimpleRnn", R.SimpleRnn(n_in=RL_F, n_out=RL_H), seq, apply)]
    cases += [(f"Bidirectional_LSTM_{mode}",
               R.Bidirectional(layer=R.LSTM(n_in=RL_F, n_out=RL_H),
                               mode=mode), seq, apply)
              for mode in ("concat", "add", "mul", "ave")]
    cases += [
        ("GravesBidirectionalLSTM",
         R.GravesBidirectionalLSTM(n_in=RL_F, n_out=RL_H), seq, apply),
        ("LastTimeStep", R.LastTimeStep(), seq, apply),
        ("RnnLossLayer", R.RnnLossLayer(), seq, rnn_loss)]
    cases += [(f"GlobalPooling_{pt}", L.GlobalPoolingLayer(pooling_type=pt),
               seq, apply) for pt in ("avg", "sum", "pnorm", "max")]
    cases += [
        ("LastTimeStepVertex", V.LastTimeStepVertex(), seq,
         lambda v, p, x, m: v.apply(x)),
        ("DuplicateToTimeSeriesVertex", V.DuplicateToTimeSeriesVertex(), seq,
         lambda v, p, x, m: v.apply(x[:, 0], x))]
    cases += [(f"ConvLSTM2D_{'seq' if rs else 'last'}",
               R.ConvLSTM2D(n_in=1, n_out=CONVLSTM_FILTERS,
                            return_sequences=rs), img, apply)
              for rs in (True, False)]
    return cases


def expected_recurrent_launches():
    """The phase's launches, worked out from the code, fp32 and bf16
    together: each Bidirectional(LSTM) pass launches K4 once a direction
    (``Bidirectional.apply``: two ``apply_seq`` calls, each one
    ``LSTMSequenceFunction`` forward; its backward is torch); each
    ConvLSTM2D pass launches the conv kernel once on the B*T images and
    once a step, and its backward (x needs no gradient) one wgrad a conv
    and one dgrad a recurrent conv after the first (h_0 is zeros and needs
    none). GravesLSTM, GRU, SimpleRnn, the heads and the vertices launch
    no kernel."""
    passes = 2  # fp32, bf16
    convlstms = 2  # return_sequences True and False
    return {"lstm_seq_fwd": passes * 4 * 2,
            "conv2d_fwd": passes * convlstms * (1 + CONVLSTM_T),
            "conv2d_wgrad": passes * convlstms * (1 + CONVLSTM_T),
            "conv2d_dgrad": passes * convlstms * (CONVLSTM_T - 1),
            "lstm_cell_fwd": 0, "flash_attention_fwd": 0}


def recurrent_layers_phase(torch, np, card):
    """Each new recurrent layer, wrapper, head and vertex (recurrent_cases)
    on CUDA tensors against the same layer on the CPU: the same params
    (drawn from a seed on the CPU), a seeded input and a (B, T) ragged
    mask, fp32 and bf16 (params cast inside autograd, as the nets do), the
    output and the gradients of a fixed random projection of it with
    respect to every param and the input (not ConvLSTM2D's input, a
    network's input needing none), gated by LAYER_TOL. Every K1, dgrad,
    K3 and K4 launch is held against its plain version
    (check_every_launch); none is plain on CUDA; the launch counts must be
    expected_recurrent_launches(). Returns the launches and the checks."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map

    cases = recurrent_cases(torch)
    checked, rows = {}, []
    kern.reset_counts()
    for ci, (name, layer, shape, run) in enumerate(cases):
        gen = torch.Generator().manual_seed(12345 + ci)
        params = (layer.initialize(gen, shape[1:])[0]
                  if hasattr(layer, "initialize") else {})
        x = torch.randn(shape, generator=gen)
        lens = torch.randint(1, shape[1] + 1, (shape[0],), generator=gen)
        lens[0] = shape[1]
        mask = (torch.arange(shape[1])[None] < lens[:, None]).float()
        x_grad = not name.startswith("ConvLSTM2D")
        rec = {"case": name, "input": list(shape)}
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            outs = {}
            for on_card in (False, True):
                dev = "cuda" if on_card else "cpu"
                p = tree_map(lambda v: v.to(dev).requires_grad_(True), params)
                xx = x.to(dev).requires_grad_(x_grad)
                ctx = (check_every_launch(torch, checked) if on_card
                       else contextlib.nullcontext())
                with ctx:
                    y = run(layer, tree_map(lambda v: v.to(dt), p),
                            xx.to(dt), mask.to(dev))
                    proj = torch.randn(y.shape, generator=torch.Generator(
                        ).manual_seed(ci)).to(dev)
                    leaves = tree_leaves(p) + ([xx] if x_grad else [])
                    grads = torch.autograd.grad((y.float() * proj).sum(),
                                                leaves, allow_unused=True)
                outs[on_card] = (y.detach().float().cpu(),
                                 [None if g is None else g.float().cpu()
                                  for g in grads])
                if on_card:
                    torch.cuda.synchronize()
            (y_cpu, g_cpu), (y_gpu, g_gpu) = outs[False], outs[True]
            if (y_gpu.shape != y_cpu.shape
                    or not torch.isfinite(y_gpu).all()
                    or any((a is None) != (b is None)
                           for a, b in zip(g_gpu, g_cpu))):
                raise AssertionError(f"recurrent_layers {name} {tag}: the "
                                     "card gave another shape, non-finite "
                                     "values or other gradients")
            fwd = _grad_error(y_gpu, y_cpu)[1]
            grad = max([_grad_error(a, b)[1] for a, b in zip(g_gpu, g_cpu)
                        if a is not None] or [0.0])
            gate_f, gate_g = LAYER_TOL[tag]
            if fwd > gate_f or grad > gate_g:
                raise AssertionError(
                    f"recurrent_layers {name} {tag}: card against CPU, "
                    f"forward {fwd:.3g} (gate {gate_f}), gradients "
                    f"{grad:.3g} (gate {gate_g})")
            rec[tag] = {"forward_err": fwd, "grad_err": grad,
                        "gradients": sum(g is not None for g in g_gpu)}
        rows.append(rec)
    launches = {k: v for k, v in kern.LAUNCHES.items()}
    want = expected_recurrent_launches()
    plain = dict(kern.PLAIN_ON_CUDA)
    if launches != want or any(plain.values()):
        raise AssertionError(f"recurrent_layers launched {launches}, "
                             f"expected {want}; plain on CUDA {plain}")
    calls = {k: v["calls"] for k, v in _checked_summary(checked).items()}
    for kname, n in want.items():
        if n and sum(c for key, c in calls.items()
                     if key.startswith(kname + "_")) != n:
            raise AssertionError(f"{kname}: {n} launches, checked {calls}")
    emit("recurrent_layers", cases=rows, tolerance=LAYER_TOL,
         seq_shape=[RL_B, RL_T, RL_F], hidden=RL_H,
         convlstm={"batch": CONVLSTM_B, "steps": CONVLSTM_T,
                   "image": [CONVLSTM_HW, CONVLSTM_HW, 1],
                   "filters": CONVLSTM_FILTERS, "kernel": [3, 3]},
         launches=launches, launches_expected=want, plain_on_cuda=plain,
         bodies=dict(kern.BODY_LAUNCHES),
         launches_checked=_checked_summary(checked), card=card)
    kern.reset_counts()
    return launches, checked


def graves_net(dtype="float32"):
    """BASELINE #3's GravesLSTM char-RNN at dl4j-examples'
    GravesLSTMCharModellingExample widths: two GravesLSTM layers of
    GRAVES_UNITS (tanh) and a softmax/MCXENT RnnOutputLayer over CHAR_SET,
    TBPTT CHAR_TBPTT, Adam(1e-3), seed 12345, on the card."""
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.recurrent import (GravesLSTM,
                                                       RnnOutputLayer)

    v = len(CHAR_SET)
    conf = (NeuralNetConfiguration.builder().seed(12345)
            .updater({"@updater": "Adam", "learning_rate": 1e-3})
            .compute_dtype(dtype).tbptt_length(CHAR_TBPTT).list()
            .layer(GravesLSTM(n_in=v, n_out=GRAVES_UNITS, activation="tanh"))
            .layer(GravesLSTM(n_in=GRAVES_UNITS, n_out=GRAVES_UNITS,
                              activation="tanh"))
            .layer(RnnOutputLayer(n_in=GRAVES_UNITS, n_out=v, loss="mcxent",
                                  activation="softmax"))
            .set_input_type((CHAR_SEQ, v)).build())
    return MultiLayerNetwork(conf).init(device="cuda")


def no_kernel(counts, what):
    """GravesLSTM has no kernel (the reference's is a jnp scan): every
    count must be 0."""
    if any(counts.values()):
        raise AssertionError(f"{what} launched {counts}")
    return 0


def graves_char_rnn_phase(torch, np, card, k4_rates):
    """BASELINE #3's form, the GravesLSTM char-RNN on MultiLayerNetwork
    (graves_net) at the char_rnn_train shape (batch 32, 1000 characters
    of SURVEY.md, TBPTT 50): (a) one segment's step under ``auto`` against
    ``exact`` and fp64 (the gradient gate); (b) the main path, CHAR_FITS
    ``fit`` calls whose loss falls (the last five segments' mean below the
    first five's), no kernel launched; (c) one bf16 ``fit`` call; (d)
    train characters/sec fp32 and bf16 (RATE_WINDOWS), one profiled
    segment, and SAMPLES x SAMPLE_LEN sampled characters with
    ``rnn_time_step``, beside char_rnn_train's K4 rates (``k4_rates``)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    corpus = char_corpus(np)
    rng = np.random.default_rng(12345)
    batches = [char_batch(torch, np, corpus, rng) for _ in range(CHAR_FITS)]

    # (a) one segment, auto against exact and fp64
    xs, ys = batches[0][0][:, :CHAR_TBPTT], batches[0][1][:, :CHAR_TBPTT]
    ones = torch.ones(CHAR_BATCH, device="cuda")
    parity = step_against_exact(
        torch, graves_net(), (None, xs, ys, ones),
        (None, xs.double(), ys.double(), ones.double()),
        lambda: no_kernel(dict(kern.LAUNCHES), "the GravesLSTM auto step"))

    # (b) the main path
    net = graves_net()
    kern.reset_counts()
    t0 = time.perf_counter()
    with recording_losses(net) as seg_losses:
        for x, y in batches:
            net.fit(x, y)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    no_kernel(dict(kern.LAUNCHES), "the GravesLSTM fit calls")
    plain = dict(kern.PLAIN_ON_CUDA)
    losses = [float(v) for v in seg_losses]
    segments = CHAR_FITS * CHAR_SEQ // CHAR_TBPTT
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if (len(losses) != segments or any(plain.values())
            or not all(math.isfinite(v) for v in losses) or last5 >= first5):
        raise AssertionError(f"GravesLSTM char-RNN: {len(losses)} segments, "
                             f"plain on CUDA {plain}, losses {losses}")

    # (c) one bf16 fit call
    net16 = graves_net("bfloat16")
    kern.reset_counts()
    net16.fit(*batches[0])
    torch.cuda.synchronize()
    no_kernel(dict(kern.LAUNCHES), "the bf16 GravesLSTM fit call")
    loss16 = net16.get_score()
    if not math.isfinite(loss16):
        raise AssertionError(f"bf16 GravesLSTM loss {loss16}")

    # (d) rates (windows of one fit call over the first GRAVES_RATE_SEQ
    # characters: the rate is per character, the same for any number of
    # segments), a profiled segment, sampling
    x, y = batches[0]
    xr, yr = x[:, :GRAVES_RATE_SEQ], y[:, :GRAVES_RATE_SEQ]
    rates = {"fp32": chars_per_sec(torch, net, xr, yr),
             "bf16": chars_per_sec(torch, net16, xr, yr)}
    prof = profile_char_segment(torch, net, x, y)
    t0 = time.perf_counter()
    texts = sample_chars(torch, np, net, np.random.default_rng(12345), 1e-4)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    emit("graves_char_rnn", model="GravesLSTM char-RNN (BASELINE #3)",
         source="dl4j-examples GravesLSTMCharModellingExample: 2 x "
                "GravesLSTM(200, tanh), RnnOutputLayer softmax/MCXENT, "
                "minibatch 32, 1000 characters, TBPTT 50",
         reduced=["corpus: SURVEY.md on 47 symbols, not the example's "
                  "Shakespeare", "updater: Adam(1e-3), as char_rnn_train, "
                  "not the example's RmsProp(0.1) with l2 0.001",
                  "no gradient clipping (the reference has none)"],
         characters=len(CHAR_SET), units=GRAVES_UNITS,
         params=net.num_params(), batch=CHAR_BATCH, seq=CHAR_SEQ,
         tbptt=CHAR_TBPTT, **parity, fit_calls=CHAR_FITS,
         segments=len(losses), loss_first5=first5, loss_last5=last5,
         segment_losses=losses, checked_fit_wall_s=fit_s,
         launches=0, plain_on_cuda=plain, loss_bf16_fit_call=loss16,
         train_chars_per_sec_fp32=rates["fp32"],
         train_chars_per_sec_bf16=rates["bf16"], rate_seq=GRAVES_RATE_SEQ,
         k4_lstm_train_chars_per_sec=k4_rates,
         graves_over_k4_fp32=rates["fp32"]["median"]
         / k4_rates["fp32"]["median"],
         graves_over_k4_bf16=rates["bf16"]["median"]
         / k4_rates["bf16"]["median"],
         profile=prof, sample_wall_s=sample_s,
         sample_chars_per_sec=SAMPLES * SAMPLE_LEN / sample_s,
         excerpt=texts[0][:60], card=card)
    kern.reset_counts()


def review_batches(torch, np, n=SENT_BATCHES):
    """Word2VecSentimentRNN's shape on seeded data: ``n`` batches of
    SENT_BATCH reviews of 32-256 steps (numpy seed 12345; each batch padded
    to its longest review, as the example's iterator pads), SENT_FEATURES
    N(0, 1) features a step on the card, the feature mask, and the label:
    the sign of the review's masked mean projected on a fixed seeded unit
    vector. Returns [(x, mask, class index, lengths)]."""
    rng = np.random.default_rng(12345)
    gen = torch.Generator(device="cuda").manual_seed(12345)
    u = torch.randn(SENT_FEATURES, device="cuda", generator=gen)
    u = u / u.norm()
    out = []
    for _ in range(n):
        lens = torch.from_numpy(rng.integers(SENT_MIN_LEN, SENT_MAX_LEN + 1,
                                             size=SENT_BATCH)).cuda()
        t = int(lens.max())
        mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).float()
        x = torch.randn((SENT_BATCH, t, SENT_FEATURES), device="cuda",
                        generator=gen) * mask[..., None]
        cls = ((x.sum(1) / lens[:, None]) @ u > 0).long()
        out.append((x, mask, cls, lens))
    return out


def sent_datasets(torch, kind, reviews):
    """DataSets of ``reviews`` for graph ``kind``: "last" (labels and label
    mask at each review's last real step, as the example places them) or
    "pool" (one label a review)."""
    from deeplearning4j_tpu_torch.data import DataSet

    out = []
    for x, mask, cls, lens in reviews:
        if kind == "pool":
            out.append(DataSet(x, torch.eye(2, device="cuda")[cls], mask))
            continue
        rows = torch.arange(x.shape[0], device="cuda")
        y = torch.zeros((x.shape[0], x.shape[1], 2), device="cuda")
        y[rows, lens - 1, cls] = 1.0
        lmask = torch.zeros_like(mask)
        lmask[rows, lens - 1] = 1.0
        out.append(DataSet(x, y, mask, lmask))
    return out


def sent_graph(kind, dtype="float32", seq_buckets=None):
    """The sentiment graphs: "last" is in -> LSTM(300 -> 256) ->
    RnnOutputLayer(2); "pool" is in -> Bidirectional(LSTM(300 -> 256),
    concat) -> GlobalPoolingLayer(avg, masked) -> OutputLayer(2). Adam
    SENT_LR, seed 12345, on the card; ``seq_buckets`` on the conf."""
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import recurrent as R

    gb = (NeuralNetConfiguration.builder().seed(12345)
          .updater({"@updater": "Adam", "learning_rate": SENT_LR})
          .compute_dtype(dtype).graph_builder().add_inputs("in"))
    lstm = R.LSTM(n_in=SENT_FEATURES, n_out=SENT_UNITS)
    if kind == "last":
        gb.add_layer("lstm", lstm, "in")
        gb.add_layer("out", R.RnnOutputLayer(n_in=SENT_UNITS, n_out=2),
                     "lstm")
    else:
        gb.add_layer("bi", R.Bidirectional(layer=lstm, mode="concat"), "in")
        gb.add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), "bi")
        gb.add_layer("out", L.OutputLayer(n_in=2 * SENT_UNITS, n_out=2),
                     "pool")
    conf = gb.set_outputs("out").set_input_types(
        (SENT_MAX_LEN, SENT_FEATURES)).build()
    conf = dataclasses.replace(conf, seq_buckets=seq_buckets)
    return ComputationGraph(conf).init(device="cuda")


def seqs_per_sec(torch, net, data, windows=RATE_WINDOWS):
    """``net.fit`` sequences/sec: ``windows`` windows of one epoch over
    ``data`` each, closed by a device sync."""
    net.fit(data[:1])
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        net.fit(data)
        torch.cuda.synchronize()
        rates.append(sum(ds.features.shape[0] for ds in data)
                     / (time.perf_counter() - t0))
    if not math.isfinite(net.get_score()):
        raise AssertionError(f"non-finite loss {net.get_score()}")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def profile_graph_step(torch, net, ds, top=8):
    """One ``fit`` step under torch.profiler: wall, device busy, idle
    share, K4's launches (the wrapper's count and the trace's) and share.
    The tracer drops ctypes launches from some traces (PERF.md §7), so
    K4's device time is also taken by CUDA events: each of the step's K4
    launches again on its own inputs in a CUDA graph (:func:`time_ms`).
    Where the trace lost a launch, its event time is added to the busy
    time; ``lstm_kernel_ms`` is the event time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.ops.kernels import lstm as klstm

    net.fit(ds)
    torch.cuda.synchronize()
    calls, launch = [], klstm.lstm_seq_fwd

    def capturing(*args, **kwargs):
        # timed again below, outside the autograd Function that launched
        # it: the raw launch refuses inputs that require grad
        calls.append((tuple(a.detach() if torch.is_tensor(a) else a
                            for a in args), kwargs))
        return launch(*args, **kwargs)

    kern.reset_counts()
    klstm.lstm_seq_fwd = capturing
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        klstm.lstm_seq_fwd = launch
    launches = lstm_only(dict(kern.LAUNCHES), "the profiled graph step")
    kernels = device_kernels(torch, prof)
    traced = sum(n for _, n, name in kernels if _is_k4(name))
    event_ms = [time_ms(torch, lambda a=a, k=k: launch(*a, **k), reps=5)
                for a, k in calls]
    k4 = sum(event_ms)
    traced_ms = sum(ms for ms, _, name in kernels if _is_k4(name))
    busy = sum(k[0] for k in kernels) - traced_ms + k4
    kern.reset_counts()
    return {"steps": int(ds.features.shape[1]), "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "lstm_kernel_ms": k4, "lstm_kernel_traced_ms": traced_ms,
            "lstm_kernel_launches": launches,
            "lstm_kernel_traced_launches": traced,
            "lstm_kernel_share_of_busy": k4 / busy if busy else None,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def sentiment_graph(torch, np, card, kind, reviews):
    """One sentiment graph (sent_graph ``kind``): a step under ``auto``
    against ``exact`` and fp64; the main path, SENT_EPOCHS epochs of
    ``fit(iterator)`` with every K4 launch checked (1 a step for "last", 2
    for "pool"), none plain, the last 10 steps' mean loss below the first
    10's; ``evaluate`` and ``score`` with masks against ``exact``; train
    sequences/sec fp32 and bf16; one profiled step. Returns (launches,
    checks)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    data = sent_datasets(torch, kind, reviews)
    per_step = 1 if kind == "last" else 2

    # (a) one step, auto against exact and fp64, the same params
    def auto_launches():
        if lstm_only(dict(kern.LAUNCHES), "the auto step") != per_step or \
                any(kern.PLAIN_ON_CUDA.values()):
            raise AssertionError(f"{kind} auto step: {dict(kern.LAUNCHES)}")

    net0 = sent_graph(kind)
    ds = data[0]
    args = net0._batch(ds.features, ds.labels, ds.features_mask,
                       ds.labels_mask)
    inputs, labels, weights, mask, lmask = args
    dbl = {k: v.double() for k, v in inputs.items()}
    parity = step_against_exact(
        torch, net0, args, (dbl, {k: v.double() for k, v in labels.items()},
                            weights.double(), mask, lmask), auto_launches)
    del net0

    # (b) the main path: fit(iterator), every K4 launch checked
    net = sent_graph(kind)
    checked = {}
    kern.reset_counts()
    t0 = time.perf_counter()
    with recording_losses(net) as step_losses, \
            check_every_launch(torch, checked):
        net.fit(data, epochs=SENT_EPOCHS)
        torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    launches = lstm_only(dict(kern.LAUNCHES), f"the {kind} graph's fit")
    plain = dict(kern.PLAIN_ON_CUDA)
    steps = SENT_EPOCHS * len(data)
    if (launches != per_step * steps or any(plain.values())
            or checked[("lstm_seq_fwd", "fp32")]["calls"] != launches):
        raise AssertionError(f"{kind}: {launches} K4 launches over {steps} "
                             f"steps (expected {per_step} a step), plain "
                             f"{plain}, checked {_checked_summary(checked)}")
    losses = [float(v) for v in step_losses]
    first10, last10 = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if (len(losses) != steps or not all(math.isfinite(v) for v in losses)
            or last10 >= first10):
        raise AssertionError(f"{kind}: losses did not fall: {losses}")

    # (c) evaluate and score with masks, against exact
    held = data[:SENT_EVAL_BATCHES]
    ev = net.evaluate(held)
    sc = net.score(held[0])
    with kern.impl_scope("exact"):
        ev_x = net.evaluate(held)
        sc_x = net.score(held[0])
    score_rel = abs(sc - sc_x) / abs(sc_x)
    if score_rel > TRAIN_LOSS_RTOL or abs(ev.accuracy()
                                          - ev_x.accuracy()) > 2e-3:
        raise AssertionError(f"{kind}: score {sc} vs exact {sc_x}, "
                             f"accuracy {ev.accuracy()} vs "
                             f"{ev_x.accuracy()}")

    # (d) one checked bf16 step, rates and a profiled step
    net16 = sent_graph(kind, "bfloat16")
    kern.reset_counts()
    with check_every_launch(torch, checked):
        net16.fit(data[0])
    torch.cuda.synchronize()
    got16 = checked.get(("lstm_seq_fwd", "bf16"), {}).get("calls")
    loss16 = net16.get_score()
    if got16 != per_step or not math.isfinite(loss16):
        raise AssertionError(f"{kind} bf16 step: {got16} launches checked, "
                             f"loss {loss16}")
    window = data[:SENT_WINDOW_BATCHES]
    rates = {"fp32": seqs_per_sec(torch, net, window),
             "bf16": seqs_per_sec(torch, net16, window)}
    prof = {"fp32": profile_graph_step(torch, net, data[0]),
            "bf16": profile_graph_step(torch, net16, data[0])}
    emit("seq_graph", graph=kind, batch=SENT_BATCH,
         source="dl4j-examples Word2VecSentimentRNN: minibatch 64, reviews "
                "truncated at 256 steps, 300 features a step, "
                "LSTM(256), 2 classes",
         reduced=["seeded N(0, 1) vectors in place of the Google News "
                  "word vectors (nothing may be fetched)",
                  "label: sign of the masked mean projected on a seeded unit "
                  "vector (learnable), not IMDB's",
                  f"Adam({SENT_LR}), no gradient normalization",
                  f"{len(data)} batches a epoch"],
         lengths=[SENT_MIN_LEN, SENT_MAX_LEN],
         params=net.num_params(), **parity, epochs=SENT_EPOCHS, steps=steps,
         loss_first10=first10, loss_last10=last10, step_losses=losses,
         launches=launches, launches_per_step=per_step,
         plain_on_cuda=plain, bodies=dict(kern.BODY_LAUNCHES),
         launches_checked=_checked_summary(checked),
         checked_wall_s=checked_s, score=sc, score_exact=sc_x,
         score_rel_err=score_rel, eval_accuracy=ev.accuracy(),
         eval_accuracy_exact=ev_x.accuracy(),
         eval_batches=len(held), loss_bf16_step=loss16,
         train_seqs_per_sec_fp32=rates["fp32"],
         train_seqs_per_sec_bf16=rates["bf16"], profile_fp32=prof["fp32"],
         profile_bf16=prof["bf16"], card=card)
    kern.reset_counts()
    return launches, checked


def char_graph(dropout=0.2):
    """TextGenerationLSTM's conf (char_net's) rebuilt as a ComputationGraph
    with ``tbptt_length(CHAR_TBPTT)``: in -> LSTM -> LSTM -> RnnOutputLayer,
    on the card."""
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.recurrent import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    v = len(CHAR_SET)
    zoo = TextGenerationLSTM(total_unique_characters=v, units=CHAR_UNITS,
                             dropout=dropout, max_length=CHAR_SEQ)
    gb = zoo._builder().graph_builder().add_inputs("in")
    gb.add_layer("l0", LSTM(n_in=v, n_out=CHAR_UNITS), "in")
    gb.add_layer("l1", LSTM(n_in=CHAR_UNITS, n_out=CHAR_UNITS,
                            dropout=dropout), "l0")
    gb.add_layer("out", RnnOutputLayer(n_in=CHAR_UNITS, n_out=v,
                                       dropout=dropout), "l1")
    conf = (gb.set_outputs("out").set_input_types((CHAR_SEQ, v))
            .tbptt_length(CHAR_TBPTT).build())
    return ComputationGraph(conf).init(device="cuda")


def graph_tbptt(torch, np, card):
    """TBPTT and stateful inference in the graph: char_graph against the
    char_rnn_train MultiLayerNetwork (char_net) from the same params, on
    the char_rnn_train phase's first batch: one ``fit`` call (40 K4
    launches, every one checked), each segment's loss and the params after
    it within GRAPH_MLN_RTOL of the network's; then ``rnn_time_step`` over
    SAMPLE_PRIME and 20 steps (2 K4 launches a call), its distributions
    within GRAPH_MLN_RTOL of the network's. Returns the launches and the
    checks."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.tree import tree_items

    corpus = char_corpus(np)
    x, y = char_batch(torch, np, corpus, np.random.default_rng(12345))
    mln, graph = char_net(), char_graph()
    for name, i in (("l0", 0), ("l1", 1), ("out", 2)):
        graph.params[name] = {k: v.clone() for k, v in mln.params[i].items()}
    checked = {}
    kern.reset_counts()
    with recording_losses(graph) as g_losses, \
            check_every_launch(torch, checked):
        graph.fit(x, y)
        torch.cuda.synchronize()
    fit_launches = lstm_only(dict(kern.LAUNCHES), "the graph's TBPTT fit")
    plain = dict(kern.PLAIN_ON_CUDA)
    with recording_losses(mln) as m_losses:
        mln.fit(x, y)
    losses = {"graph": [float(v) for v in g_losses],
              "mln": [float(v) for v in m_losses]}
    want = 2 * (CHAR_SEQ // CHAR_TBPTT)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["graph"], losses["mln"]))
    param_err = max(_grad_error(v, mln.params[i][k])[1]
                    for name, i in (("l0", 0), ("l1", 1), ("out", 2))
                    for (k,), v in tree_items(graph.params[name]))
    if (fit_launches != want or any(plain.values())
            or len(losses["graph"]) != want // 2
            or graph.iteration != mln.iteration or loss_err > GRAPH_MLN_RTOL
            or param_err > GRAPH_MLN_RTOL):
        raise AssertionError(f"graph TBPTT: {fit_launches} K4 launches "
                             f"(expected {want}), plain {plain}, loss err "
                             f"{loss_err}, param err {param_err}")

    # rnn_time_step: the prime in one call, then one step a call
    lut = {ch: i for i, ch in enumerate(CHAR_SET)}
    eye = torch.eye(len(CHAR_SET), device="cuda")
    prime = eye[torch.tensor([lut[c] for c in SAMPLE_PRIME],
                             device="cuda")][None].expand(SAMPLES, -1, -1)
    steps = eye[torch.randint(0, len(CHAR_SET), (20, SAMPLES),
                              generator=torch.Generator().manual_seed(3))
                .cuda()]
    outs = {}
    kern.reset_counts()
    for tag, net in (("graph", graph), ("mln", mln)):
        net.rnn_clear_previous_state()
        ctx = (check_every_launch(torch, checked) if tag == "graph"
               else contextlib.nullcontext())
        with ctx:
            o = [net.rnn_time_step(prime)[:, -1]]
            o += [net.rnn_time_step(s) for s in steps]
        outs[tag] = torch.stack(o)
        if tag == "graph":
            torch.cuda.synchronize()
            step_launches = lstm_only(dict(kern.LAUNCHES),
                                      "the graph's rnn_time_step")
    step_err = _grad_error(outs["graph"], outs["mln"])[1]
    if step_launches != 2 * 21 or step_err > GRAPH_MLN_RTOL:
        raise AssertionError(f"graph rnn_time_step: {step_launches} K4 "
                             f"launches (expected 42), err {step_err}")
    emit("seq_graph_tbptt", model="TextGenerationLSTM as a graph",
         batch=CHAR_BATCH, seq=CHAR_SEQ, tbptt=CHAR_TBPTT,
         fit_launches=fit_launches, segment_losses=losses["graph"],
         loss_rel_err=loss_err, param_rel_err=param_err,
         rnn_time_step_launches=step_launches,
         rnn_time_step_rel_err=step_err, tolerance=GRAPH_MLN_RTOL,
         launches_checked=_checked_summary(checked), card=card)
    kern.reset_counts()
    return {"fit": fit_launches, "rnn_time_step": step_launches}, checked


def seq_graph_phase(torch, np, card):
    """The masked sequence ComputationGraph on K4: the two sentiment graphs
    (sentiment_graph), then TBPTT and ``rnn_time_step`` in the graph
    (graph_tbptt). Returns the launches by path and every check."""
    reviews = review_batches(torch, np)
    launches, checked = {}, {}
    for kind in ("last", "pool"):
        launches[kind], c = sentiment_graph(torch, np, card, kind, reviews)
        checked[kind] = c
    del reviews
    torch.cuda.empty_cache()
    tb, checked["tbptt"] = graph_tbptt(torch, np, card)
    launches.update({f"tbptt_{k}": v for k, v in tb.items()})
    return launches, checked


# ------------------------------------------------------- the compiled step


def copy_net(net, conf=None):
    """A copy of ``net`` at its state (params, layer and optimizer states,
    iteration, dropout generator), with no programs (early stopping's
    snapshot, on the card); ``conf`` in place of its conf (another compute
    type)."""
    from deeplearning4j_tpu_torch.earlystopping import _with_state

    snap = _with_state(net, lambda t: t.detach().clone())
    if conf is not None:
        snap.conf = conf
    return snap


def fit_losses(net, calls):
    """``net.fit(*args)`` for each of ``calls``, and the loss after each,
    as the device tensors ``score_value`` holds."""
    out = []
    for args in calls:
        net.fit(*args)
        out.append(net.score_value)
    return out


def bf16_conf(net):
    return dataclasses.replace(net.conf, compute_dtype="bfloat16")


def watcher_counts(before):
    """What the CompileWatcher counted since ``before`` (a
    :func:`watcher_counts` of None): programs built by function, graphs
    captured and their warm-up and capture seconds."""
    from deeplearning4j_tpu_torch.util import get_watcher

    w = get_watcher()
    now = {"traces": dict(w.traces), "captures": w.backend_compiles,
           "capture_s": w.backend_compile_seconds}
    if before is None:
        return now
    return {"traces": {k: n - before["traces"].get(k, 0)
                       for k, n in now["traces"].items()
                       if n != before["traces"].get(k, 0)},
            "captures": now["captures"] - before["captures"],
            "capture_s": now["capture_s"] - before["capture_s"]}


def nondeterministic_ops(torch, make, steps):
    """What makes the path's eager steps nondeterministic: the kernels an
    eager run launches that it no longer launches under
    ``torch.use_deterministic_algorithms`` (the ops that take another,
    deterministic, kernel there), and PyTorch's warnings for ops with no
    deterministic CUDA kernel at all (the cuBLAS workspace notice aside);
    one profiled run of ``steps`` on a copy in each mode."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import capture

    def kernel_names(deterministic):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    capture.disabled(), \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                warnings.simplefilter("always")
                steps(make())
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        return names, {str(w.message).split(" does not have")[0]
                       for w in caught if "does not have a deterministic"
                       in str(w.message)}

    default, _ = kernel_names(False)
    deterministic, no_kernel = kernel_names(True)
    return {"kernels_replaced_under_deterministic_algorithms": sorted(
        name[:120] for name in default - deterministic),
        "ops_without_a_deterministic_kernel": sorted(no_kernel)}


def captured_rate(torch, call, rows, windows=RATE_WINDOWS):
    """``rows`` a call per second of ``call()``, a replay of a warm
    program: each window holds as many calls as fit in CAPTURE_WINDOW_S by
    a timed first call, run back to back and closed by a device sync. (A
    replay returns long before the device has run it, so a window that
    stopped on the host's clock would queue work far past its end.)"""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    n = max(1, int(CAPTURE_WINDOW_S / (time.perf_counter() - t0)))
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        rates.append(rows * n / (time.perf_counter() - t0))
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates, "calls_a_window": n}


def capture_gate(torch, make, steps, what):
    """The captured-against-eager gate: ``steps(net)`` (which returns its
    losses as tensors) on three copies from ``make()``, eager, eager again,
    then captured (``nn/capture.py``). Where the two eager runs agree to
    the bit (losses, params, layer and optimizer states), the captured run
    must too. Where they do not, the ops that make the path
    nondeterministic are named, and the three runs are made again under
    ``torch.use_deterministic_algorithms``: where its eager runs agree to
    the bit, the captured run must too; where they still do not, it may be
    no farther from the first eager run than the repeat is. The first loss
    is held to the bit either way: it is the first step's forward, dropout
    masks included, before any gradient. Returns (the captured net, its
    run's launches and plain-on-CUDA counts, the gate's record)."""
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.tree import tree_items

    def run(eager):
        net = make()
        kern.reset_counts()
        with capture.disabled() if eager else contextlib.nullcontext():
            losses = steps(net)
        torch.cuda.synchronize()
        counts = ({k: v for k, v in kern.LAUNCHES.items() if v},
                  {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v})
        state = [torch.stack([torch.as_tensor(v).float() for v in losses])]
        state += [t.detach() for _, t in tree_items(
            {"p": net.params, "s": net.states, "o": net.opt_states})]
        return net, state, counts

    def dist(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    def three():
        _, e1, _ = run(True)
        _, e2, _ = run(True)
        net, cap, counts = run(False)
        return net, e1, cap, counts, dist(e1, e2), dist(e1, cap)

    net, e1, cap, (launches, plain), rep, got = three()
    rec = {"steps": int(e1[0].numel()), "eager_repeat_max_diff": rep,
           "captured_max_diff": got, "eager_deterministic": rep == 0.0,
           "bit_equal": got == 0.0,
           "first_loss_bit_equal": bool(cap[0][0] == e1[0][0]),
           "losses_eager": e1[0].tolist(), "losses_captured": cap[0].tolist()}
    if rep > 0.0:
        rec["nondeterministic_ops"] = nondeterministic_ops(torch, make,
                                                           steps)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, e1d, capd, _, rep_d, got_d = three()
        finally:
            torch.use_deterministic_algorithms(False)
        rec["deterministic_algorithms"] = {
            "eager_repeat_max_diff": rep_d, "captured_max_diff": got_d,
            "bit_equal": got_d == 0.0,
            "first_loss_bit_equal": bool(capd[0][0] == e1d[0][0])}
        if got_d > rep_d or not rec["deterministic_algorithms"][
                "first_loss_bit_equal"]:
            raise AssertionError(
                f"{what} under deterministic algorithms: the captured run "
                f"is {got_d} from the eager run, its repeat {rep_d}")
    elif got > 0.0:
        raise AssertionError(f"{what}: two eager runs agree to the bit, "
                             f"the captured run is {got} from them")
    if not rec["first_loss_bit_equal"]:
        raise AssertionError(f"{what}: first losses {cap[0][0]} captured, "
                             f"{e1[0][0]} eager")
    progs = net.programs()
    rec["programs"] = {name: {"pool_bytes": p.pool_bytes,
                              "replays": p.replays}
                       for name, p in progs.items()}
    if not progs or any(p.graph is None for p in progs.values()):
        raise AssertionError(f"{what}: no captured program ran ({progs})")
    if not all(math.isfinite(v) for v in rec["losses_captured"]):
        raise AssertionError(f"{what}: losses {rec['losses_captured']}")
    return net, launches, plain, rec


def profile_captured_step(torch, step, top=8):
    """One call of ``step`` (a step of a warm program) under
    torch.profiler: its wall, the device's busy time (the traced kernels'
    sum) and idle share, and the step's device span by CUDA events beside
    them (first kernel to last, gaps included). Where the trace holds no
    kernel of the replayed graph, the busy time is the event span."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer's warm-up kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    traced = sum(k[0] for k in kernels)
    span = start.elapsed_time(end)
    busy = traced if traced > 0.0 else span
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_from": "trace" if traced > 0.0 else "events",
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "event_span_ms": span,
            "traced_kernels": sum(k[1] for k in kernels),
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def eager(phase, **match):
    """The fields of this run's earlier (eager) ``phase`` line whose fields
    match ``match``."""
    for fields in EMITTED.get(phase, []):
        if all(fields.get(k) == v for k, v in match.items()):
            return fields
    raise AssertionError(f"no {phase} line with {match}")


def rate_pair(captured, eager_rate):
    """A captured rate beside the eager one, and their ratio (medians)."""
    return {"captured": captured, "eager": eager_rate,
            "captured_over_eager": captured["median"] / eager_rate["median"]}


def capture_serve_phase(torch, np, card):
    """ResNet-50 served from captured forwards: ``warmup`` (through the
    server's start) captures one forward a batch bucket; the same requests
    as ``serve``; every chunk the program answered equal to the bit to the
    eager forward of the same chunk, 53 K1 launches a chunk under replay,
    none plain; forward images/sec at batch 32 captured, fp32 and bf16,
    beside ``throughput``'s eager ones; a bf16 net's forward after a
    captured ``fit`` step equal to the eager forward, the eager cast cache
    filled before the step (the cast-cache hazard)."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    model = ServingModel(net, "resnet50",
                         bucketing=BucketingPolicy(batch_buckets=BUCKETS))
    router = ModelRouter()
    router.register(model, max_wait_ms=100.0, queue_limit=64)
    w0 = watcher_counts(None)
    t0 = time.perf_counter()
    server = ModelServer(router, port=0).start()  # captures every bucket
    warm_s = time.perf_counter() - t0
    built = watcher_counts(w0)
    progs = {p.inputs[0]["input"].shape[0]: p
             for p in net._aot_forward.values()}
    if (sorted(progs) != sorted(BUCKETS) or model.warmed is not True
            or any(p.graph is None for p in progs.values())):
        raise AssertionError(f"warmup captured {sorted(progs)}")
    parts = {"warmup": warm_s}
    t = time.perf_counter()
    rng = np.random.default_rng(12345)
    xs = [quarter_grid(np, rng, r) for r in SERVE_ROWS]
    bodies = [{"inputs": x.tolist()} for x in xs]
    url = f"{server.url}/v1/models/resnet50/infer"
    served, output = [], net.output
    parts["requests_json"] = time.perf_counter() - t

    def recording(x, *a, **k):
        out = output(x, *a, **k)
        served.append((x, out))
        return out

    net.output = recording
    try:
        kern.reset_counts()
        chunks0 = model.chunks_executed
        replays0 = sum(p.replays for p in progs.values())
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:  # two waves of 4 concurrent
            answers = list(pool.map(lambda b: _post(url, b), bodies[:4]))
            answers += list(pool.map(lambda b: _post(url, b), bodies[4:]))
        serve_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = kern.LAUNCHES["conv2d_fwd"]
        plain = kern.PLAIN_ON_CUDA["conv2d_fwd"]
        chunks = model.chunks_executed - chunks0
    finally:
        server.stop()
        del net.output
    if chunks < 1 or launches != 53 * chunks or plain:
        raise AssertionError(f"{launches} K1 launches for {chunks} chunks, "
                             f"{plain} plain on CUDA")
    parts["serve"] = serve_s
    t = time.perf_counter()
    replays = sum(p.replays for p in progs.values()) - replays0
    if replays != chunks or len(served) != chunks:
        raise AssertionError(f"{replays} replays, {len(served)} outputs for "
                             f"{chunks} chunks")
    with capture.disabled():
        chunk_diff = max(float((out - net.output(x)).abs().max())
                         for x, out in served)
        max_err = 0.0
        for x, (body, _lat) in zip(xs, answers):
            got = np.asarray(body["outputs"], np.float32)
            ref = net.output(x).cpu().numpy()
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError(f"response shape {got.shape}")
            max_err = max(max_err, float(np.abs(got - ref).max()))
    if chunk_diff != 0.0 or max_err > 1e-4:
        raise AssertionError(f"served chunks {chunk_diff} from the eager "
                             f"forward, requests {max_err}")

    parts["checks"] = time.perf_counter() - t
    t = time.perf_counter()
    net16 = copy_net(net, bf16_conf(net))
    x = torch.randn((32, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    rates = {tag: captured_rate(torch, lambda n=n: n.output(x), 32)
             for tag, n in (("fp32", net), ("bf16", net16))}
    parts["rates"] = time.perf_counter() - t
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((32, 224, 224, 3), device="cuda", generator=gen)
    y = torch.eye(1000, device="cuda")[torch.arange(32, device="cuda")]
    with capture.disabled():
        net16.output(x)  # fills the eager cast cache
    before = net16.output(x)
    net16.fit(x, y)  # a captured step: the params move inside the graph
    after = net16.output(x)
    with capture.disabled():
        after_eager = net16.output(x)
    if torch.equal(after, before) or not torch.equal(after, after_eager):
        raise AssertionError("bf16 forward after a captured step: moved "
                             f"{not torch.equal(after, before)}, equal to "
                             f"eager {torch.equal(after, after_eager)}")
    parts["bf16_after_fit"] = time.perf_counter() - t
    thr = eager("throughput")
    emit("capture_serve", model="ResNet50", buckets=list(BUCKETS),
         warmup_s=warm_s, built=built, seconds=parts,
         pool_bytes={b: progs[b].pool_bytes for b in sorted(progs)},
         requests=len(SERVE_ROWS), chunks=chunks, conv_launches=launches,
         plain_on_cuda=plain, chunks_bit_equal_to_eager=True,
         max_abs_err_requests_vs_eager=max_err, serve_wall_s=serve_s,
         served_rows_per_s={
             "captured": sum(SERVE_ROWS) / serve_s,
             "eager": eager("serve")["served_rows_per_s"]},
         forward_images_per_sec_fp32=rate_pair(
             rates["fp32"], thr["forward_images_per_sec_fp32"]),
         forward_images_per_sec_bf16=rate_pair(
             rates["bf16"], thr["forward_images_per_sec_bf16"]),
         window_s=CAPTURE_WINDOW_S, bf16_forward_after_captured_fit=
         "moved, and equal to the eager forward (cast cache refilled)",
         card=card)
    return launches


def capture_train_phase(torch, np, card):
    """ResNet-50 ``fit`` at batch 32, Adam(1e-3), fp32 and bf16, captured:
    CAPTURE_STEPS steps under the gate, 53 / 52 / 53 K1 / dgrad / K3
    launches a step under replay, none plain; train images/sec and one
    profiled captured step beside ``train_throughput``'s and
    ``train_profile``'s eager ones."""
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    batch = 32
    proto = ResNet50().init(device="cuda")
    _calm_residual_branches(proto)
    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        np.random.default_rng(12345).integers(0, 1000, batch)]).cuda()
    per_step = {"conv2d_fwd": 53, "conv2d_dgrad": 52, "conv2d_wgrad": 53}

    def steps(net):
        return fit_losses(net, [(x, y)] * CAPTURE_STEPS)

    thr, launches = eager("train_throughput"), {}
    for tag, conf in (("fp32", None), ("bf16", bf16_conf(proto))):
        w0 = watcher_counts(None)
        net, got, plain, gate = capture_gate(
            torch, lambda: copy_net(proto, conf), steps, f"ResNet-50 {tag}")
        if got != {k: CAPTURE_STEPS * v for k, v in per_step.items()} \
                or plain:
            raise AssertionError(f"{tag}: {got} launches in "
                                 f"{CAPTURE_STEPS} captured steps, plain "
                                 f"{plain}")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        rate = captured_rate(torch, lambda: net.fit(x, y), batch)
        if not math.isfinite(net.get_score()):
            raise AssertionError(f"ResNet-50 {tag}: {net.get_score()}")
        prof = profile_captured_step(torch, lambda: net.fit(x, y))
        ep = eager("train_profile", dtype=tag)
        emit("capture_train", model="ResNet50", dtype=tag, batch=batch,
             updater=proto.conf.updater, gate=gate, launches=got,
             launches_per_step=per_step, plain_on_cuda=plain,
             built=watcher_counts(w0),
             train_images_per_sec=rate_pair(
                 rate, thr[f"train_images_per_sec_{tag}"]),
             window_s=CAPTURE_WINDOW_S, profile_captured=prof,
             eager_profile={k: ep[k] for k in ("wall_ms", "device_busy_ms",
                                               "idle_share")},
             replay_wall_over_eager_wall=prof["wall_ms"] / ep["wall_ms"],
             card=card)
        del net
        torch.cuda.empty_cache()
    return launches


def capture_bert_train_phase(torch, np, card):
    """BERT-base ``fit`` at batch 32, S 128, hidden dropout 0.1, Adam,
    fp32 and bf16 (integer ids), captured: CAPTURE_STEPS steps of
    BertIterator batches under the gate (the first loss, with its dropout
    masks, equal to the bit), 12 K5 launches a step under replay, none
    plain; train sequences/sec at S 128 and one profiled captured step
    beside ``bert_train_throughput``'s and ``bert_train_profile``'s."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nlp import Vocab

    text, labels = bert_corpus()
    data = [_ds_on_card(torch, b, torch.int64) for b in
            itertools.islice(bert_iterator(Vocab.build(text), text, labels),
                             CAPTURE_STEPS)]
    proto = bert_train_net(torch, num_classes=2)
    if proto.conf.layers[1].hidden_dropout != 0.1:
        raise AssertionError("BERT-base trains with hidden dropout 0.1")

    def steps(net):
        return fit_losses(net, [(DataSet(x, y, m),) for x, y, m in data])

    rng = np.random.default_rng(11)
    xs = torch.from_numpy(bert_rows(np, BERT_TRAIN_BATCH, BERT_TRAIN_SEQ, rng,
                                    np.int64)).cuda()
    ys = torch.eye(2, device="cuda")[torch.from_numpy(
        rng.integers(0, 2, size=BERT_TRAIN_BATCH)).cuda()]
    thr, launches = eager("bert_train_throughput"), 0
    for tag, conf in (("fp32", None), ("bf16", bf16_conf(proto))):
        w0 = watcher_counts(None)
        net, got, plain, gate = capture_gate(
            torch, lambda: copy_net(proto, conf), steps, f"BERT-base {tag}")
        if got != {"flash_attention_fwd": BERT_LAYERS * CAPTURE_STEPS} \
                or plain:
            raise AssertionError(f"{tag}: {got} launches in "
                                 f"{CAPTURE_STEPS} captured steps, plain "
                                 f"{plain}")
        launches += got["flash_attention_fwd"]
        rate = captured_rate(torch, lambda: net.fit(xs, ys),
                             BERT_TRAIN_BATCH)
        if not math.isfinite(net.get_score()):
            raise AssertionError(f"BERT-base {tag}: {net.get_score()}")
        prof = profile_captured_step(torch, lambda: net.fit(xs, ys))
        ep = eager("bert_train_profile", dtype=tag)
        emit("capture_bert_train", model="Bert.base", dtype=tag,
             batch=BERT_TRAIN_BATCH, seq=BERT_TRAIN_SEQ, hidden_dropout=0.1,
             gate=gate, launches=got, launches_per_step=BERT_LAYERS,
             plain_on_cuda=plain, built=watcher_counts(w0),
             train_sequences_per_sec=rate_pair(
                 rate, thr["sequences_per_sec"][f"seq128_{tag}"]),
             window_s=CAPTURE_WINDOW_S, profile_captured=prof,
             eager_profile={k: ep.get(k) for k in ("wall_ms",
                                                   "device_busy_ms",
                                                   "idle_share")},
             card=card)
        del net
        torch.cuda.empty_cache()
    return launches


def capture_small_phase(torch, np, card):
    """The smaller paths captured, fp32, each under the gate with its
    launch counts, its captured rate and a profiled captured step beside
    its eager phase's: the char-RNN's TBPTT (a fit call of 1000 characters:
    20 segments, 40 K4 launches), LeNet (4 steps, 2 / 1 / 2 conv launches
    a step; rates over LENET_CAPTURE_BATCHES batches), the GravesLSTM
    char-RNN (reduced: a fit call of GRAVES_GATE_SEQ characters in the
    gate, GRAVES_RATE_SEQ in the rate, as graves_char_rnn's), the two
    sentiment graphs (4 batches, K4 once / twice a step, a program a
    ``seq_buckets`` bucket the batches fall in). Then the RecompileListener
    over a ragged LeNet epoch (10 batches of 64 and one of 32), with and
    without ``batch_buckets`` (64,). Returns each path's captured
    launches."""
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.listeners import RecompileListener
    from deeplearning4j_tpu_torch.zoo import LeNet

    launches = {}

    def path(name, make, steps, want, rate_fn, step_fn, eager_rate,
             eager_prof, **extra):
        w0 = watcher_counts(None)
        net, got, plain, gate = capture_gate(torch, make, steps, name)
        if got != want or plain:
            raise AssertionError(f"{name}: {got} launches captured, "
                                 f"expected {want}; plain {plain}")
        launches[name] = got
        rate = rate_fn(net)
        prof = profile_captured_step(torch, lambda: step_fn(net))
        emit("capture_path", path=name, gate=gate, launches=got,
             plain_on_cuda=plain, built=watcher_counts(w0),
             rate=rate_pair(rate, eager_rate), profile_captured=prof,
             eager_profile={k: eager_prof.get(k) for k in (
                 "wall_ms", "device_busy_ms", "idle_share")},
             card=card, **extra)
        return net

    # the char-RNN, TBPTT 50 over 1000 characters
    corpus = char_corpus(np)
    x, y = char_batch(torch, np, corpus, np.random.default_rng(12345))
    proto = char_net()
    net = path("char_rnn_tbptt", lambda: copy_net(proto),
               lambda n: fit_losses(n, [(x, y)]),
               {"lstm_seq_fwd": 2 * CHAR_SEQ // CHAR_TBPTT},
               lambda n: chars_per_sec(torch, n, x, y),
               lambda n: n.fit(x[:, :CHAR_TBPTT], y[:, :CHAR_TBPTT]),
               eager("char_rnn_throughput")["train_chars_per_sec_fp32"],
               eager("char_rnn_profile"), unit="characters/sec",
               batch=CHAR_BATCH, seq=CHAR_SEQ, tbptt=CHAR_TBPTT)
    if len(net._tbptt_steps) != 1:
        raise AssertionError(f"{len(net._tbptt_steps)} TBPTT programs")
    del net, proto

    # LeNet at batch 64
    train = MnistDataSetIterator(batch=LENET_BATCH,
                                 n_examples=LENET_BATCH
                                 * LENET_CAPTURE_BATCHES)
    batches = list(train)
    xl = torch.from_numpy(batches[0].features).cuda()
    yl = torch.from_numpy(batches[0].labels).cuda()
    proto = LeNet().init(device="cuda")
    path("lenet", lambda: copy_net(proto),
         lambda n: fit_losses(n, [(ds,) for ds in batches[:CAPTURE_STEPS]]),
         {k: CAPTURE_STEPS * v for k, v in LENET_STEP.items()},
         lambda n: lenet_windows(torch, n, batches),
         lambda n: n.fit(xl, yl),
         eager("lenet_throughput")["train_images_per_sec_fp32"],
         eager("lenet_profile", dtype="fp32"), unit="images/sec",
         batch=LENET_BATCH, rate_batches=LENET_CAPTURE_BATCHES)
    del proto

    # the GravesLSTM char-RNN (no kernel: plain torch, captured whole)
    proto = graves_net()
    xg, yg = x[:, :GRAVES_GATE_SEQ], y[:, :GRAVES_GATE_SEQ]
    xr, yr = x[:, :GRAVES_RATE_SEQ], y[:, :GRAVES_RATE_SEQ]
    eg = eager("graves_char_rnn")
    path("graves_char_rnn", lambda: copy_net(proto),
         lambda n: fit_losses(n, [(xg, yg)]), {},
         lambda n: chars_per_sec(torch, n, xr, yr),
         lambda n: n.fit(x[:, :CHAR_TBPTT], y[:, :CHAR_TBPTT]),
         eg["train_chars_per_sec_fp32"], eg["profile"],
         unit="characters/sec", gate_seq=GRAVES_GATE_SEQ,
         rate_seq=GRAVES_RATE_SEQ,
         reduced=[f"the gate's fit call is {GRAVES_GATE_SEQ} characters "
                  f"({GRAVES_GATE_SEQ // CHAR_TBPTT} segments), not 1000"])
    del proto

    # the sentiment graphs, one program a seq_buckets bucket
    reviews = review_batches(torch, np, n=CAPTURE_STEPS)
    buckets_used = sorted({next(b for b in SENT_SEQ_BUCKETS
                                if b >= r[0].shape[1]) for r in reviews})
    for kind, per_step in (("last", 1), ("pool", 2)):
        proto = sent_graph(kind, seq_buckets=SENT_SEQ_BUCKETS)
        data = sent_datasets(torch, kind, reviews)
        es = eager("seq_graph", graph=kind)
        net = path(f"seq_graph_{kind}", lambda: copy_net(proto),
                   lambda n: fit_losses(n, [(ds,) for ds in data]),
                   {"lstm_seq_fwd": per_step * CAPTURE_STEPS},
                   lambda n: seqs_per_sec(torch, n,
                                          data[:SENT_WINDOW_BATCHES]),
                   lambda n: n.fit(data[0]),
                   es["train_seqs_per_sec_fp32"], es["profile_fp32"],
                   unit="sequences/sec", seq_buckets=SENT_SEQ_BUCKETS,
                   buckets_used=buckets_used,
                   reduced=["each batch pads to its seq_buckets bucket "
                            "(the eager seq_graph rate pads to the batch's "
                            "longest review)"])
        if len(net._aot_steps) != len(buckets_used):
            raise AssertionError(f"{kind}: {len(net._aot_steps)} programs "
                                 f"for buckets {buckets_used}")
        del net, proto

    # RecompileListener over a ragged epoch
    events = {}
    ragged = MnistDataSetIterator(batch=LENET_BATCH,
                                  n_examples=10 * LENET_BATCH + 32)
    for tag, buckets in (("bucketed", (LENET_BATCH,)), ("unbucketed", None)):
        conf = dataclasses.replace(LeNet().conf(), batch_buckets=buckets)
        net = MultiLayerNetwork(conf).init(device="cuda")
        listener = RecompileListener(grace=1, log_fn=lambda s: None)
        net.set_listeners(listener)
        net.fit(ragged)
        events[tag] = listener.events
    if events["bucketed"] or events["unbucketed"] != [
            (11, "MultiLayerNetwork.train_step", 1)]:
        raise AssertionError(f"RecompileListener events {events}")
    emit("capture_recompile", epoch_batches=[LENET_BATCH] * 10 + [32],
         events=events, watcher=watcher_counts(None), card=card)
    emit("capture_gc", **capture_after_dead_net(torch, np), card=card)
    return launches


def capture_after_dead_net(torch, np):
    """LeNet A captured, then dropped: it is cyclic garbage (net ->
    program -> body -> net), freed only by the cyclic collector. LeNet B's
    train step is then captured with a hook inside the captured loss that
    drops A's last reference and collects wherever the collector is on, as
    it may at any allocation (a collection inside a capture destroys A's
    graph there and breaks the capture: CUDA error 901, PR 13's call 13).
    The collector must be off inside, A freed after, and B's first loss
    equal to the bit to an eager twin's."""
    import gc
    import weakref

    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.nn import layers as TL
    from deeplearning4j_tpu_torch.zoo import LeNet

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((LENET_BATCH, 28, 28, 1),
                                    dtype=np.float32)).cuda()
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, LENET_BATCH)]).cuda()
    dead = [LeNet().init(device="cuda")]
    dead[0].fit(x, y)
    gone = weakref.ref(dead[0])
    orig, seen = TL.OutputLayer.compute_loss, []

    def collecting(self, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            dead.clear()
            seen.append(gc.isenabled())
            if gc.isenabled():
                gc.collect()
        return orig(self, *a, **k)

    TL.OutputLayer.compute_loss = collecting
    try:
        net = LeNet().init(device="cuda")
        net.fit(x, y)
    finally:
        TL.OutputLayer.compute_loss = orig
    gc.collect()
    eager = LeNet().init(device="cuda")
    with capture.disabled():
        eager.fit(x, y)
    rec = {"collector_on_inside_capture": seen,
           "dead_net_freed_after": gone() is None,
           "programs": len(net._aot_steps), "loss_captured": net.get_score(),
           "loss_eager": eager.get_score()}
    if (seen != [False] or not rec["dead_net_freed_after"]
            or not rec["programs"]
            or rec["loss_captured"] != rec["loss_eager"]):
        raise AssertionError(f"capture after a dead captured net: {rec}")
    return rec


# ------------------------------------------------------------ op table

# the first separable block of the reference's Xception
# (deeplearning4j_tpu/zoo/models.py:389) at 299x299x3: its two 3x3
# separable convs on the 150x150 map after the stem, 64 -> 128 and
# 128 -> 128, batch 8
XCEPTION_SEPARABLE = ((8, 150, 150, 64, 128), (8, 150, 150, 128, 128))
OP_LSTM = (32, 50, 47, 256)      # the char-RNN's B, T, inputs, H
OP_LSTM_LAYOUTS = tuple((d, layout) for d in ("forward", "reverse",
                                              "bidirectional")
                        for layout in (0, 1))


def expected_op_table_launches(registry, geometries):
    """The op_table phase's launches, worked out from the code: the sweep
    (every name and alias once: op_cases.KERNEL_LAUNCHES of its op), then
    the full-width calls in fp32 and bf16 (the ResNet-50 geometries' dgrad and
    wgrad once each, the Xception depthwise conv once and its two
    separable convs twice each, lstm_layer in 3 directions x 2 layouts with
    2 launches bidirectional, conv_lstm_2d 1 + CONVLSTM_T)."""
    from deeplearning4j_tpu_torch.ops import op_cases as oc

    want = {}

    def add(kname, n):
        want[kname] = want.get(kname, 0) + n

    names = registry.list_ops() + [registry.aliases()[a]
                                   for a in sorted(registry.aliases())]
    for name in names:
        for kname, n in oc.KERNEL_LAUNCHES.get(name, {}).items():
            add(kname, n)
    dtypes = 2
    add("conv2d_dgrad", dtypes * len(geometries))
    add("conv2d_wgrad", dtypes * len(geometries))
    add("conv2d_fwd", dtypes * (1 + 2 * len(XCEPTION_SEPARABLE)))
    add("lstm_seq_fwd", dtypes * 2 * (1 + 1 + 2))
    add("conv2d_fwd", dtypes * (1 + CONVLSTM_T))
    return want


def op_table_sweep(torch, np):
    """Every registered name and alias on CUDA tensors against the same
    call on the CPU, from the seeded cases, held to the family's tolerance
    (op_cases.compare; random ops by their moments, decompositions by
    reconstruction). Returns {family: max err}, {category: ops checked},
    the names run."""
    import deeplearning4j_tpu_torch.ops as ops
    from deeplearning4j_tpu_torch.ops import op_cases as oc

    cases = oc.build(0)
    aliases = ops.aliases()
    runs = [(n, n) for n in ops.list_ops()] + [(a, aliases[a])
                                               for a in sorted(aliases)]

    def on(device):
        def tensor(a):
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        def key(k):
            return torch.Generator(device=device).manual_seed(k.seed)
        return tensor, key

    errs, by_cat, failures = {}, {}, []
    for name, canonical in runs:
        case = cases[canonical]
        try:
            got = oc.to_numpy(oc.run(ops.exec_op, name, case, *on("cuda")))
            want = oc.to_numpy(oc.run(ops.exec_op, canonical, case,
                                      *on("cpu")))
            err = oc.compare(case, got, want)
        except Exception as e:  # noqa: BLE001 - collected, then raised
            failures.append(f"{name}: {type(e).__name__}: {e}"[:300])
            continue
        errs[case.family] = max(errs.get(case.family, 0.0), err)
        if name == canonical:
            cat = ops.get_op(name).category
            by_cat[cat] = by_cat.get(cat, 0) + 1
    if failures:
        raise AssertionError(f"op_table: {len(failures)} ops disagree on "
                             f"the card: {failures[:12]}")
    return errs, by_cat, len(runs)


def op_table_full_width(torch, np, geometries):
    """The kernel-backed ops by name at full width, fp32 and bf16:
    conv2d_backprop_input/filter at each ResNet-50 conv geometry at batch
    8, depthwise_conv2d and separable_conv2d at Xception's first separable
    block, lstm_layer at the char-RNN's width in every direction and
    layout with ragged seq_lens (fp32 also against the CPU within 1e-4,
    and its gradients of x, W, R and b within 1e-4 of the largest),
    conv_lstm_2d at ConvLSTM2D's B 8, T 10, 64x64x1 -> 64. Returns a
    record per group."""
    import deeplearning4j_tpu_torch.ops as ops
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    gen = torch.Generator(device="cuda").manual_seed(2024)
    ct_gen = torch.Generator().manual_seed(2025)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {"resnet50_grads": 0, "xception": 0, "lstm_layer": [],
           "conv_lstm_2d": 0}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for key in geometries:
            n, h, w, cin, kh, kw, cout, stride, padding, dil, _ = key
            strides = (stride, stride) if isinstance(stride, int) else stride
            pads = kconv.resolve_padding(padding, (h, w), (kh, kw), strides,
                                         dil)
            oh = (h + sum(pads[0]) - (kh - 1) * dil[0] - 1) // strides[0] + 1
            ow = (w + sum(pads[1]) - (kw - 1) * dil[1] - 1) // strides[1] + 1
            x, dy = rand(n, h, w, cin).to(dt), rand(n, oh, ow, cout).to(dt)
            wt = rand(kh, kw, cin, cout,
                      scale=math.sqrt(2.0 / (kh * kw * cin))).to(dt)
            dx = ops.exec_op("conv2d_backprop_input", wt, dy, x.shape,
                             strides=strides, padding=padding, dilation=dil)
            dw = ops.exec_op("conv2d_backprop_filter", x, dy, wt.shape,
                             strides=strides, padding=padding, dilation=dil)
            if (tuple(dx.shape) != tuple(x.shape) or dx.dtype != dt
                    or tuple(dw.shape) != tuple(wt.shape)
                    or not torch.isfinite(dx.float()).all()
                    or not torch.isfinite(dw.float()).all()):
                raise AssertionError(f"conv backprop ops {key} {tag}")
            out["resnet50_grads"] += 1
        for n, h, w, cin, cout in XCEPTION_SEPARABLE:
            x = rand(n, h, w, cin).to(dt)
            dw_ = rand(3, 3, cin, 1, scale=1 / 3).to(dt)
            pw = rand(1, 1, cin, cout, scale=math.sqrt(1 / cin)).to(dt)
            if cin == XCEPTION_SEPARABLE[0][3]:
                y = ops.exec_op("depthwise_conv2d", x, dw_)
                assert tuple(y.shape) == (n, h, w, cin)
            y = ops.exec_op("separable_conv2d", x, dw_, pw)
            if tuple(y.shape) != (n, h, w, cout) or not torch.isfinite(
                    y.float()).all():
                raise AssertionError(f"separable {tag}: {tuple(y.shape)}")
            out["xception"] += 1
        b, t, f, hid = OP_LSTM
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        lens[0] = t
        for direction, layout in OP_LSTM_LAYOUTS:
            d = 2 if direction == "bidirectional" else 1
            x = rand(t, b, f) if layout == 0 else rand(b, t, f)
            args = [x, rand(d, 4 * hid, f, scale=0.1),
                    rand(d, 4 * hid, hid, scale=0.06), rand(d, 8 * hid,
                                                           scale=0.1),
                    lens.to(torch.int32)]
            kw = dict(hidden_size=hid, direction=direction, layout=layout)
            if tag == "fp32":  # its gradient too, below
                for a in args[:4]:
                    a.requires_grad_(True)
            got = ops.exec_op("lstm_layer", *[a.to(dt) if a.is_floating_point()
                                              else a for a in args], **kw)
            rec = {"dtype": tag, "direction": direction, "layout": layout}
            if tag == "fp32":
                cpu = [a.detach().cpu().requires_grad_(a.requires_grad)
                       for a in args]
                ref = ops.exec_op("lstm_layer", *cpu, **kw)
                rec["max_abs_err_vs_cpu"] = max(
                    float((g.detach().cpu() - r.detach()).abs().max())
                    for g, r in zip(got, ref))
                # d(sum(out * ct)) / d(x, W, R, b): the kernel route's
                # adjoint (LSTMSequenceFunction) against the CPU's autograd
                # through the plain step loop
                cts = [torch.randn(o.shape, generator=ct_gen)
                       for o in ref]
                sum((o * c.cuda()).sum() for o, c in zip(got, cts)).backward()
                sum((o * c).sum() for o, c in zip(ref, cts)).backward()
                rec["max_grad_err_vs_cpu"] = max(
                    float((a.grad.cpu() - c.grad).abs().max())
                    / max(float(c.grad.abs().max()), 1.0)
                    for a, c in zip(args[:4], cpu[:4]))
                if rec["max_abs_err_vs_cpu"] > 1e-4 or \
                        rec["max_grad_err_vs_cpu"] > 1e-4:
                    raise AssertionError(f"lstm_layer {rec}")
            elif not all(torch.isfinite(g.float()).all() for g in got):
                raise AssertionError(f"lstm_layer {rec}: non-finite")
            out["lstm_layer"].append(rec)
        x = rand(CONVLSTM_B, CONVLSTM_T, CONVLSTM_HW, CONVLSTM_HW, 1).to(dt)
        f4 = 4 * CONVLSTM_FILTERS
        y, _ = ops.exec_op("conv_lstm_2d", x, rand(3, 3, 1, f4,
                                                    scale=0.3).to(dt),
                           rand(3, 3, CONVLSTM_FILTERS, f4,
                                scale=0.04).to(dt),
                           rand(f4, scale=0.1).to(dt))
        if tuple(y.shape) != (CONVLSTM_B, CONVLSTM_T, CONVLSTM_HW,
                              CONVLSTM_HW, CONVLSTM_FILTERS) or \
                not torch.isfinite(y.float()).all():
            raise AssertionError(f"conv_lstm_2d {tag}: {tuple(y.shape)}")
        out["conv_lstm_2d"] += 1
    return out


def op_table_phase(torch, np, card):
    """The whole op table by name on the card (op_table_sweep), then the
    kernel-backed ops at full width (op_table_full_width), every K1,
    dgrad, K3, K4 and K5 launch held against its plain version
    (check_every_launch), none plain on CUDA, the launches equal to
    expected_op_table_launches. Returns the launches and the checks."""
    import deeplearning4j_tpu_torch.ops as ops
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.ops import op_cases as oc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    geometries = sorted(conv_geometries(ResNet50().conf(), 8), key=repr)
    want = expected_op_table_launches(ops.registry, geometries)
    checked = {}
    kern.reset_counts()
    t0 = time.perf_counter()
    with check_every_launch(torch, checked):
        errs, by_cat, n_runs = op_table_sweep(torch, np)
        t1 = time.perf_counter()
        full = op_table_full_width(torch, np, geometries)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kern.LAUNCHES.items() if v}
    plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
    if launches != want or plain:
        raise AssertionError(f"op_table launched {launches}, expected "
                             f"{want}; plain on CUDA {plain}")
    calls = {k: v["calls"] for k, v in _checked_summary(checked).items()}
    for kname, n in want.items():
        if sum(c for key, c in calls.items()
               if key.startswith(kname + "_")) != n:
            raise AssertionError(f"{kname}: {n} launches, checked {calls}")
    emit("op_table", ops=ops.op_count(), names_and_aliases_run=n_runs,
         checked_by_category=by_cat, max_err_by_family=errs,
         tolerance_by_family=oc.TOLERANCES, sweep_s=t1 - t0,
         full_width_s=time.perf_counter() - t1,
         full_width={"resnet50_backprop_geometries": len(geometries),
                     **full},
         launches=launches, launches_expected=want, plain_on_cuda=plain,
         bodies=dict(kern.BODY_LAUNCHES),
         launches_checked=_checked_summary(checked), card=card)
    kern.reset_counts()
    return launches, checked


# ------------------------------------------------------------ the conv zoo

# Xception at its published form (reference zoo/models.py:389): 299x299x3,
# 1000 classes, 8 middle repeats, random weights from seed 12345; served in
# BUCKETS, trained at batch 32 under the zoo's Adam(1e-3); 74 K1, 74 K3 and
# 73 dgrad launches a step (6 convs and 34 separable convs, each a
# depthwise launch with one channel a group and a 1x1 pointwise launch;
# the stem reads the input, so it has no dgrad)
XCEPTION_INPUT, XCEPTION_BATCH = (299, 299, 3), 32
XCEPTION_STEP = {"conv2d_fwd": 74, "conv2d_wgrad": 74, "conv2d_dgrad": 73}
# its depthwise geometries, (H = W, C, stride): 3x3, stride 1, SAME,
# groups = C, whose kernel records run at batch 8 as the ResNet-50
# geometries do
DEPTHWISE = ((150, 64, 1), (150, 128, 1), (75, 128, 1), (75, 256, 1),
             (38, 256, 1), (38, 728, 1), (19, 728, 1), (10, 1024, 1),
             (10, 1536, 1))
# the rate windows (fewer than ResNet-50's: a step takes near a second)
# and the captured leg's steps under the gate
ZOO_WINDOWS, ZOO_CAPTURE_STEPS = 3, 2
# the other eight zoo models, each at the reference's default input, batch
# 8, forward within ZOO_TOL of the plain path on the card
ZOO_OTHERS = ("SimpleCNN", "AlexNet", "VGG16", "VGG19", "Darknet19",
              "SqueezeNet", "InceptionResNetV1", "FaceNetNN4Small2")
ZOO_BATCH, ZOO_TOL = 8, 1e-4


def expected_conv_launches(conf):
    """{kernel: launches} of one train step worked out from a conf (a graph
    or a layer stack): one of each kernel a ConvolutionLayer,
    DepthwiseConvolution2D or Convolution1D, two a
    SeparableConvolution2D (its depthwise and pointwise convs); one dgrad
    fewer where the conv reads a network input, which needs no gradient.
    A forward launches the step's ``conv2d_fwd`` count."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import layers_spatial as LS

    if hasattr(conf, "nodes"):
        items = [(n.node, bool(set(n.inputs) & set(conf.inputs)))
                 for n in conf.nodes]
    else:
        items = [(lyr, i == 0) for i, lyr in enumerate(conf.layers)]
    fwd = dgrad = 0
    for lyr, reads_input in items:
        n = (2 if isinstance(lyr, L.SeparableConvolution2D) else
             1 if isinstance(lyr, (L.ConvolutionLayer,
                                   LS.DepthwiseConvolution2D,
                                   LS.Convolution1D)) else 0)
        fwd += n
        dgrad += n - (1 if n and reads_input else 0)
    return {"conv2d_fwd": fwd, "conv2d_wgrad": fwd, "conv2d_dgrad": dgrad}


def conv_only(counts, want, what):
    """The conv kernels' counts of ``counts``; any other kernel launched
    fails."""
    if any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{what} launched {dict(counts)}")
    return {k: counts[k] for k in want}


def calibrate_batchnorm(torch, net, x, classes):
    """Every batchnorm's running statistics set to the batch statistics of
    ``x`` (one training forward with the EMA's decay at 0), so the
    inference forward of the random-weight net normalises as training
    does: without it each separable conv's output shrinks by ~sqrt(2/C)
    (the He init's fan counts all C channels, a depthwise output sums 9
    terms) and the probabilities all sit within 1e-5 of 1/1000."""
    import dataclasses as dc

    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.tree import tree_copy_

    swapped = [(n, n.node) for n in net.topo
               if isinstance(n.node, L.BatchNormalization)]
    for n, bn in swapped:
        n.node = dc.replace(bn, decay=0.0)
    try:
        with torch.no_grad():
            y = torch.zeros((x.shape[0], classes), device=x.device)
            _, states, _ = net._loss(
                {net.conf.inputs[0]: x}, {net.conf.outputs[0]: y},
                torch.ones(x.shape[0], device=x.device))
        tree_copy_(net.states, states)
    finally:
        for n, bn in swapped:
            n.node = bn


@contextlib.contextmanager
def time_grouped_launches(torch, out):
    """While active, each launch of K1, dgrad or K3 with more than one
    group (Xception's depthwise convs) runs between two CUDA events, and
    ``out`` collects {kernel: [event pairs]} for :func:`events_ms`."""
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    where = {"conv2d_fwd": 5, "conv2d_dgrad": 6, "conv2d_wgrad": 7}
    saved = {name: getattr(kconv, name) for name in where}

    def wrap(name):
        kernel = saved[name]

        def timed_call(*args, **kwargs):
            if args[where[name]] == 1:
                return kernel(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = kernel(*args, **kwargs)
            end.record()
            out.setdefault(name, []).append((start, end))
            return result
        return timed_call

    for name in where:
        setattr(kconv, name, wrap(name))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(kconv, name, fn)


def events_ms(pairs):
    """{kernel: (device ms summed, launches)} of time_grouped_launches'
    events (after a sync)."""
    return {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
            for k, v in pairs.items()}


def depthwise_records(torch, conf, geometries, count, line):
    """K1, dgrad and K3 against their plain versions and cuDNN at a
    model's depthwise ``geometries`` (check_geometry, check_grad_geometry;
    stride 1 SAME, stride 2 VALID), fp32 and bf16, batch 8; a ``line``
    line each, with its launches a pass (forward, dgrad and K3 alike) in
    ``conf``, whose ``count`` depthwise convs must have just these
    geometries."""
    per_pass = depthwise_geometries(conf)
    if (sorted(per_pass) != sorted(geometries)
            or sum(per_pass.values()) != count):
        raise AssertionError(f"{line}: the depthwise convs {per_pass}")
    records = []
    for hw, c, s in geometries:
        key = (8, hw, hw, c, 3, 3, c, (s, s), "SAME" if s == 1 else "VALID",
               (1, 1), c)
        fwd = check_geometry(torch, key, 0)
        grad = check_grad_geometry(torch, key, 0, 0)
        rec = {"hw": hw, "c": c, "stride": s,
               "per_pass": per_pass[(hw, c, s)],
               **{f"fwd_{t}": fwd[t] for t in ("fp32", "bf16")},
               **{f"{k}_{t}": grad[f"{k}_{t}"] for k in ("dgrad", "wgrad")
                  for t in ("fp32", "bf16")}}
        records.append(rec)
        emit(line, batch=8, **rec)
    return records


def xception_conf(dtype="float32"):
    from deeplearning4j_tpu_torch.zoo.models import Xception

    return Xception(input_shape=XCEPTION_INPUT, compute_dtype=dtype).conf()


def xception(torch, dtype="float32"):
    from deeplearning4j_tpu_torch.nn import ComputationGraph

    return ComputationGraph(xception_conf(dtype)).init(device="cuda")


def depthwise_geometries(conf):
    """{(H, C, stride): launches a pass} of a graph's depthwise convs: its
    DepthwiseConvolution2D nodes and the depthwise halves of its
    SeparableConvolution2D nodes (3x3, one channel a group, square;
    stride 1 SAME, stride 2 VALID on a padded map), walking the conf with
    the layers' shape rules."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import layers_spatial as LS

    shape_of = dict(zip(conf.inputs, map(tuple, conf.input_shapes)))
    out = {}
    for n in conf.topological_order():
        ins = [shape_of[i] for i in n.inputs]
        if not n.is_layer:
            shape_of[n.name] = tuple(n.node.output_shape(*ins))
            continue
        if isinstance(n.node, (L.SeparableConvolution2D,
                               LS.DepthwiseConvolution2D)):
            h, w, c = ins[0]
            s = tuple(n.node.stride)
            if (h != w or tuple(n.node.kernel_size) != (3, 3) or s[0] != s[1]
                    or n.node.padding != ("SAME" if s == (1, 1)
                                          else "VALID")
                    or n.node.depth_multiplier != 1):
                raise AssertionError(f"{n.name}: not a depthwise geometry "
                                     "of the smoke's")
            out[(h, c, s[0])] = out.get((h, c, s[0]), 0) + 1
        shape_of[n.name] = tuple(n.node.output_shape(ins[0]))
    return out


def xception_batch(torch, np, batch=XCEPTION_BATCH, seed=3):
    x = torch.randn((batch,) + XCEPTION_INPUT, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed))
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        np.random.default_rng(12345).integers(0, 1000, batch)]).cuda()
    return x, y


def eager_train_leg(torch, card, prefix, model, net, net16, x, y, per_step,
                    steps, bf16_steps):
    """A model's eager training on (x, y) on the card, every launch
    checked: a step under auto against exact with the gate's controls
    (step_parity; a ``<prefix>_train_parity`` line), ``steps`` checked
    fp32 fit steps whose loss must fall (``<prefix>_train``),
    ``bf16_steps`` checked steps of ``net16``, the bf16 net
    (``<prefix>_train_bf16``), both at ``per_step`` launches a step and
    none plain; images/sec of both (``<prefix>_train_throughput``) and a
    profiled step of each (``<prefix>_train_profile``). Returns the
    launches and the checks of the fp32 and bf16 steps by part."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    batch = x.shape[0]
    launches, checked = {}, {}
    torch.cuda.reset_peak_memory_stats()
    parity = step_parity(torch, net, x, y, per_step, model)
    emit(f"{prefix}_train_parity", model=model, batch=batch, **parity,
         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9, card=card)
    torch.cuda.reset_peak_memory_stats()
    losses, launches["fit"], checked["fit"] = checked_fit(
        torch, net, x, y, per_step, steps, model)
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{model}'s losses did not fall: {losses}")
    emit(f"{prefix}_train", model=model, batch=batch,
         params=net.num_params(), updater=net.conf.updater, steps=steps,
         losses=losses, launches=launches["fit"],
         launches_checked=_checked_summary(checked["fit"]),
         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9, card=card)
    checked["fit_bf16"], losses16 = {}, []
    kern.reset_counts()
    with check_every_launch(torch, checked["fit_bf16"]):
        for _ in range(bf16_steps):
            net16.fit(x, y)
            losses16.append(net16.get_score())
    torch.cuda.synchronize()
    got16 = _launch_summary(checked["fit_bf16"], "bf16")
    if (got16 != {k: bf16_steps * v for k, v in per_step.items()}
            or any(kern.PLAIN_ON_CUDA.values())
            or not all(math.isfinite(v) for v in losses16)):
        raise AssertionError(f"{model} bf16 steps checked {got16}, plain "
                             f"{dict(kern.PLAIN_ON_CUDA)}, losses "
                             f"{losses16}")
    launches["fit_bf16"] = got16
    emit(f"{prefix}_train_bf16", model=model, batch=batch, steps=bf16_steps,
         losses=losses16, loss_fell=losses16[-1] < losses16[0],
         launches_checked=_checked_summary(checked["fit_bf16"]),
         conv_bodies=dict(kern.BODY_LAUNCHES), card=card)
    nets = (("fp32", net), ("bf16", net16))
    rates = {tag: train_images_per_sec(torch, n, x, y, windows=ZOO_WINDOWS)
             for tag, n in nets}
    emit(f"{prefix}_train_throughput", model=model, batch=batch,
         path="net.fit", window_s=RATE_WINDOW_S,
         **{f"train_images_per_sec_{t}": r for t, r in rates.items()},
         card=card)
    for tag, n in nets:
        emit(f"{prefix}_train_profile", model=model, dtype=tag, batch=batch,
             card=card, **profile_train_step(torch, n, x, y))
    return launches, checked


def conv_zoo_phase(torch, np, card):
    """The conv zoo (ROADMAP item 4) on the card, eagerly, every launch
    checked: the depthwise kernel records; Xception served over HTTP; its
    training at batch 32 (a step under auto against exact with the gate's
    controls, four checked Adam steps, a checked bf16 step, images/sec, a
    profiled step with the depthwise launches as their own class); the
    other eight zoo models' checked forward and fit step. Returns the
    launches by part, the checks, the depthwise records and the state
    the captured leg starts from."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    launches, checked = {}, {}
    records = depthwise_records(torch, xception_conf(), DEPTHWISE, 34,
                                "conv_zoo_depthwise")
    kern.reset_counts()

    # Xception served: BN statistics from a calibration batch, then 8
    # requests of 1-16 rows over HTTP, 74 K1 launches a chunk, each checked
    net = xception(torch)
    x, y = xception_batch(torch, np)
    calibrate_batchnorm(torch, net, x, 1000)
    fields, launches["serve"], serve_checked = serve_and_check(
        torch, np, net, "xception", XCEPTION_INPUT, XCEPTION_STEP[
            "conv2d_fwd"])
    checked["serve"] = serve_checked
    emit("conv_zoo_serve", model="Xception", input=list(XCEPTION_INPUT),
         classes=1000, params=net.num_params(), calibrated_batchnorm=True,
         **fields, card=card)
    emit("conv_zoo_throughput", model="Xception", batch=XCEPTION_BATCH,
         path="net.output", window_s=RATE_WINDOW_S,
         forward_images_per_sec_fp32=forward_rows_per_sec(
             torch, net, x, windows=ZOO_WINDOWS), card=card)
    del net
    torch.cuda.empty_cache()

    # Xception trained at batch 32 under the zoo's Adam(1e-3); one bf16
    # step
    net = xception(torch)
    got, chk = eager_train_leg(torch, card, "conv_zoo", "Xception", net,
                               xception(torch, "bfloat16"), x, y,
                               XCEPTION_STEP, 4, 1)
    launches.update(got)
    checked.update(chk)
    proto = copy_net(net)
    del net
    torch.cuda.empty_cache()

    # the other eight models
    launches["others"], checked["others"] = {}, {}
    for name in ZOO_OTHERS:
        got, chk = zoo_model_check(torch, np, name, card)
        launches["others"][name] = got
        for key, rec in chk.items():
            have = checked["others"].setdefault(key, {
                "calls": 0, "max_err_normalised": 0.0, "max_abs_err": 0.0})
            have["calls"] += rec["calls"]
            for f in ("max_err_normalised", "max_abs_err"):
                have[f] = max(have[f], rec[f])
        torch.cuda.empty_cache()
    kern.reset_counts()
    return launches, checked, records, proto, (x, y)


def zoo_model_check(torch, np, name, card):
    """One zoo model at the reference's default input and batch 8: its
    forward (inference and train mode) within ZOO_TOL of the plain path,
    then one fit step, every launch checked and the launches equal to the
    conf's worked-out counts (expected_conv_launches)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.zoo import models as zoo

    t0 = time.perf_counter()
    model = getattr(zoo, name)()
    net = model.init(device="cuda")
    want = expected_conv_launches(net.conf)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((ZOO_BATCH,) + tuple(model.input_shape), device="cuda",
                    generator=gen)
    y = torch.from_numpy(np.eye(model.num_classes, dtype=np.float32)[
        np.random.default_rng(7).integers(0, model.num_classes,
                                          ZOO_BATCH)]).cuda()
    with kern.impl_scope("exact"):
        refs = [net.output(x), net.output(x, train=True)]
    checked = {}
    kern.reset_counts()
    with check_every_launch(torch, checked):
        outs = [net.output(x), net.output(x, train=True)]
        fwd_launches = kern.LAUNCHES["conv2d_fwd"]
        net.fit(x, y)
    torch.cuda.synchronize()
    launches = conv_only(kern.LAUNCHES, want, name)
    plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
    step = {k: launches[k] - (2 * want["conv2d_fwd"] if k == "conv2d_fwd"
                              else 0) for k in want}
    if fwd_launches != 2 * want["conv2d_fwd"] or step != want or plain:
        raise AssertionError(f"{name}: forwards launched {fwd_launches}, "
                             f"the step {step}, expected {want}; plain "
                             f"{plain}")
    calls = {k: sum(r["calls"] for (kk, _), r in checked.items() if kk == k)
             for k in want}
    if calls != launches:
        raise AssertionError(f"{name}: {launches} launches, {calls} checked")
    errs = [float((o.double() - r.double()).abs().max())
            for o, r in zip(outs, refs)]
    loss = net.get_score()
    if max(errs) > ZOO_TOL or not math.isfinite(loss):
        raise AssertionError(f"{name}: forward off the plain path by {errs}"
                             f" (gate {ZOO_TOL}), loss {loss}")
    emit("conv_zoo_model", model=name, input=list(model.input_shape),
         classes=model.num_classes, params=net.num_params(),
         batch=ZOO_BATCH, forward_max_abs_err_vs_exact=errs[0],
         train_mode_forward_max_abs_err_vs_exact=errs[1],
         max_prob=float(outs[0].max()), loss=loss,
         launches_per_step=want, launches=launches, plain_on_cuda=plain,
         launches_checked=_checked_summary(checked),
         seconds=time.perf_counter() - t0, card=card)
    return launches, checked


def captured_train_phase(torch, card, prefix, model, proto, batch,
                         per_step, steps):
    """A model's fit captured (nn/capture.py), fp32 and bf16, from
    ``proto``: ``steps`` steps on ``batch`` under the capture gate,
    ``per_step`` launches a step under replay, none plain; captured
    images/sec and a profiled captured step beside the eager ones (the
    ``<prefix>_train_throughput`` and ``<prefix>_train_profile`` lines); a
    ``<prefix>_captured`` line each. Returns the launches of both."""
    x, y = batch
    thr, launches = eager(f"{prefix}_train_throughput"), {}

    def run(net):
        return fit_losses(net, [(x, y)] * steps)

    for tag, conf in (("fp32", None), ("bf16", bf16_conf(proto))):
        net, got, plain, gate = capture_gate(
            torch, lambda: copy_net(proto, conf), run, f"{model} {tag}")
        if got != {k: steps * v for k, v in per_step.items()} or plain:
            raise AssertionError(f"{model} {tag}: {got} launches in {steps} "
                                 f"captured steps, plain {plain}")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        rate = captured_rate(torch, lambda: net.fit(x, y), x.shape[0],
                             windows=ZOO_WINDOWS)
        prof = profile_captured_step(torch, lambda: net.fit(x, y))
        ep = eager(f"{prefix}_train_profile", dtype=tag)
        emit(f"{prefix}_captured", model=model, dtype=tag,
             batch=x.shape[0], gate=gate, launches=got,
             launches_per_step=per_step, plain_on_cuda=plain,
             train_images_per_sec=rate_pair(
                 rate, thr[f"train_images_per_sec_{tag}"]),
             profile_captured=prof,
             eager_profile={k: ep[k] for k in ("wall_ms", "device_busy_ms",
                                               "idle_share",
                                               "trace_complete")},
             peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
             card=card)
        del net
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ keras import

KERAS_DIR = os.path.join(ROOT, "build", "smoke_keras")
# tf.keras.applications.MobileNetV2(weights=None) at its published width:
# 224x224x3, 1000 classes, alpha 1.0, weights from seed 12345
# (keras_cases.mobilenet_v2_h5), served and trained at batch 32
MNV2_INPUT, MNV2_CLASSES, MNV2_SEED, MNV2_BATCH = (224, 224, 3), 1000, \
    12345, 32
MNV2_PARAMS = 3538984  # params and BN moving statistics, as Keras counts
MNV2_STEP = {"conv2d_fwd": 52, "conv2d_wgrad": 52, "conv2d_dgrad": 51}
# its 17 depthwise convs (3x3, groups = C) as (H = W read, C, stride): the
# stride-2 ones read the ZeroPadding2D((0, 1), (0, 1)) output, VALID
MNV2_DEPTHWISE = ((112, 32, 1), (56, 144, 1), (28, 192, 1), (14, 384, 1),
                  (14, 576, 1), (7, 960, 1), (113, 96, 2), (57, 144, 2),
                  (29, 192, 2), (15, 576, 2))
# forward against the exact path: fp32 within 1e-4 of the largest value
# (features of order 1); bf16 (the net's compute type) within LAYER_TOL's
# bf16 forward gate of the fp32 exact path
KERAS_TOL = 1e-4
# the checked fit steps, fp32 and bf16 from one state, and the captured
# leg's steps under the gate
MNV2_STEPS = 4
# the small leg: imported keras_cases files and the other new layer
# classes, the card against the CPU
KERAS_SMALL_B = 8


def _launch_summary(checked, tag):
    return {k: r["calls"] for (k, t), r in checked.items() if t == tag}


def _normalised(a, b):
    """max |a - b| over max |b| (the reference's own largest magnitude, so
    near-uniform probabilities are held relative to their size), in
    fp64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def mobilenet_batch(torch, np, batch=MNV2_BATCH, seed=3):
    x = torch.randn((batch,) + MNV2_INPUT, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed))
    y = torch.from_numpy(np.eye(MNV2_CLASSES, dtype=np.float32)[
        np.random.default_rng(12345).integers(0, MNV2_CLASSES, batch)]).cuda()
    return x, y


def mobilenet_forward(torch, net, x, tag):
    """The imported net's feed_forward and output on ``x`` under auto,
    every K1 launch checked (check_every_launch), 52 a pass, none plain;
    returns (features, probabilities, logits in fp64, launches,
    checks)."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    checked = {}
    kern.reset_counts()
    with check_every_launch(torch, checked):
        ff = net.feed_forward(x)
        out = net.output(x)
    torch.cuda.synchronize()
    want = {"conv2d_fwd": 2 * MNV2_STEP["conv2d_fwd"]}
    launches = conv_only(kern.LAUNCHES, want, f"MobileNetV2 {tag} forward")
    plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
    if launches != want or plain or _launch_summary(
            checked, tag) != want:
        raise AssertionError(f"MobileNetV2 {tag} forward: {launches} "
                             f"launched, {_checked_summary(checked)} "
                             f"checked, plain {plain}")
    feats = ff["global_average_pooling2d"].float()
    head = net.params["predictions"]
    logits = feats.double() @ head["W"].double() + head["b"].double()
    return feats, out.float(), logits, launches, checked


def mobilenet_trainable(torch, net):
    """The imported graph with its head an OutputLayer (MCXENT) under
    Adam(1e-3), the imported params and states copied in, on the card."""
    from deeplearning4j_tpu_torch.imports import keras_cases
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.computation_graph import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.tree import tree_copy_

    conf = ComputationGraphConfiguration.from_json(
        keras_cases.with_output_head(net.conf.to_json(),
                                     Adam(learning_rate=1e-3).to_dict()))
    out = ComputationGraph(conf).init(device="cuda")
    tree_copy_(out.params, net.params)
    tree_copy_(out.states, net.states)
    out._drop_programs()
    return out


def keras_small_cases(torch):
    """(name, layer, input shape, mask) of each new layer class the small
    leg runs on the card against the CPU."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import layers_spatial as LS
    from deeplearning4j_tpu_torch.nn import recurrent as R

    b = KERAS_SMALL_B
    seq, img, vol = (b, 64, 32), (b, 28, 28, 32), (b, 8, 16, 16, 8)
    return [
        ("DepthwiseConvolution2D_m2_s2", LS.DepthwiseConvolution2D(
            depth_multiplier=2, stride=(2, 2), padding="VALID"), img),
        ("DepthwiseConvolution2D_s1", LS.DepthwiseConvolution2D(), img),
        ("Convolution1D", LS.Convolution1D(n_out=64, kernel_size=5,
                                           stride=2), seq),
        ("Subsampling1DLayer", LS.Subsampling1DLayer(pooling_type="avg"),
         seq),
        ("Cropping1D", LS.Cropping1D(cropping=(2, 3)), seq),
        ("ZeroPadding1DLayer", LS.ZeroPadding1DLayer(padding=(1, 2)), seq),
        ("Upsampling1D", LS.Upsampling1D(size=2), seq),
        ("Convolution3D", LS.Convolution3D(n_out=16), vol),
        ("Subsampling3DLayer", LS.Subsampling3DLayer(), vol),
        ("Cropping3D", LS.Cropping3D(), vol),
        ("ZeroPadding3DLayer", LS.ZeroPadding3DLayer(), vol),
        ("Upsampling3D", LS.Upsampling3D(), vol),
        ("PReLULayer", LS.PReLULayer(), img),
        ("RepeatVector", LS.RepeatVector(n=10), (b, 32)),
        ("TimeDistributed", LS.TimeDistributed(
            underlying=L.DenseLayer(n_in=32, n_out=48, activation="relu")),
         seq),
        ("MaskZeroLayer", LS.MaskZeroLayer(
            underlying=R.LSTM(n_in=32, n_out=64), carry_masked_output=True),
         seq),
        ("LocallyConnected2D", LS.LocallyConnected2D(
            n_out=16, kernel_size=(3, 3), stride=(2, 2)), (b, 16, 16, 8)),
        ("LocallyConnected1D", LS.LocallyConnected1D(n_out=16,
                                                     kernel_size=3), seq),
        ("ElementWiseMultiplicationLayer",
         LS.ElementWiseMultiplicationLayer(activation="tanh"), seq),
        ("MaskLayer", LS.MaskLayer(), seq),
    ]


def expected_small_launches():
    """The small layer cases' launches, fp32 and bf16 together: each
    depthwise layer and the Conv1D one K1, one dgrad and one K3 a pass
    (forward and backward, the input needing a gradient); MaskZeroLayer's
    LSTM one K4 segment launch (its backward is torch)."""
    passes = 2
    return {"conv2d_fwd": passes * 3, "conv2d_dgrad": passes * 3,
            "conv2d_wgrad": passes * 3, "lstm_seq_fwd": passes * 1,
            "lstm_cell_fwd": 0, "flash_attention_fwd": 0}


def keras_small_phase(torch, np, card):
    """The small leg: the Conv1D stack (K1), a depth_multiplier-2 stride-2
    depthwise layer (K1) and the char-RNN-width LSTM (K4) imported from
    keras_cases files on the card and on the CPU, outputs within 1e-4 of
    the largest, their launches counted and checked; then each layer
    class of nn/layers_spatial.py forward and backward on the card against
    the CPU (keras_small_cases, fp32 and bf16, LAYER_TOL), every launch
    checked, the counts expected_small_launches()."""
    from deeplearning4j_tpu_torch.imports import KerasModelImport, keras_cases
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map

    os.makedirs(KERAS_DIR, exist_ok=True)
    files = [
        ("conv1d", keras_cases.conv1d_h5(os.path.join(KERAS_DIR, "c.h5")),
         (KERAS_SMALL_B, 128, 64), {"conv2d_fwd": 2}),
        ("depthwise_m2", keras_cases.depthwise_h5(
            os.path.join(KERAS_DIR, "d.h5"), size=56, channels=64),
         (KERAS_SMALL_B, 56, 56, 64), {"conv2d_fwd": 1}),
        ("lstm", keras_cases.lstm_h5(os.path.join(KERAS_DIR, "l.h5")),
         (32, 50, 47), {"lstm_seq_fwd": 1}),
    ]
    checked, rows = {}, []
    for name, path, shape, want in files:
        x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
        cpu = KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cpu")
        gpu = KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cuda")
        ref = cpu.output(x)
        kern.reset_counts()
        with check_every_launch(torch, checked):
            got = gpu.output(x.cuda())
        torch.cuda.synchronize()
        launches = {k: v for k, v in kern.LAUNCHES.items() if v}
        plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
        err = _normalised(got.cpu(), ref)
        if launches != want or plain or err > KERAS_TOL:
            raise AssertionError(f"keras_small {name}: launched {launches} "
                                 f"(expected {want}), plain {plain}, "
                                 f"card against CPU {err}")
        rows.append({"file": name, "input": list(shape),
                     "layers": [type(lyr).__name__
                                for lyr in gpu.conf.layers],
                     "launches": launches, "max_err_normalised": err})
    kern.reset_counts()
    layer_rows = []
    for ci, (name, layer, shape) in enumerate(keras_small_cases(torch)):
        gen = torch.Generator().manual_seed(777 + ci)
        params = layer.initialize(gen, shape[1:])[0]
        x = torch.randn(shape, generator=gen)
        if name == "MaskZeroLayer":
            x[:, 40:] = 0.0
        mask = (torch.arange(shape[1])[None] < torch.randint(
            1, shape[1] + 1, (shape[0],), generator=gen)[:, None]).float()
        rec = {"case": name, "input": list(shape)}
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            outs = {}
            for on_card in (False, True):
                dev = "cuda" if on_card else "cpu"
                p = tree_map(lambda v: v.to(dev).requires_grad_(True),
                             params)
                xx = x.to(dev).requires_grad_(True)
                kw = {"mask": mask.to(dev)} if name == "MaskLayer" else {}
                ctx = (check_every_launch(torch, checked) if on_card
                       else contextlib.nullcontext())
                with ctx:
                    y = layer.apply(tree_map(lambda v: v.to(dt), p), {},
                                    xx.to(dt), **kw)[0]
                    proj = torch.randn(y.shape, generator=torch.Generator(
                        ).manual_seed(ci)).to(dev)
                    leaves = tree_leaves(p) + [xx]
                    grads = torch.autograd.grad((y.float() * proj).sum(),
                                                leaves)
                outs[on_card] = (y.detach().float().cpu(),
                                 [g.float().cpu() for g in grads])
            (y_cpu, g_cpu), (y_gpu, g_gpu) = outs[False], outs[True]
            if y_gpu.shape != y_cpu.shape or not torch.isfinite(y_gpu).all():
                raise AssertionError(f"keras_small {name} {tag}: shape "
                                     f"{tuple(y_gpu.shape)} or non-finite")
            fwd = _grad_error(y_gpu, y_cpu)[1]
            grad = max(_grad_error(a, b)[1] for a, b in zip(g_gpu, g_cpu))
            gate_f, gate_g = LAYER_TOL[tag]
            if fwd > gate_f or grad > gate_g:
                raise AssertionError(
                    f"keras_small {name} {tag}: card against CPU, forward "
                    f"{fwd:.3g} (gate {gate_f}), gradients {grad:.3g} "
                    f"(gate {gate_g})")
            rec[tag] = {"forward_err": fwd, "grad_err": grad}
        layer_rows.append(rec)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kern.LAUNCHES.items()}
    want = expected_small_launches()
    plain = dict(kern.PLAIN_ON_CUDA)
    if launches != want or any(plain.values()):
        raise AssertionError(f"keras_small layers launched {launches}, "
                             f"expected {want}; plain on CUDA {plain}")
    totals = {}
    for (k, _), r in checked.items():
        totals[k] = totals.get(k, 0) + r["calls"]
    want_checked = {k: v + sum(f[3].get(k, 0) for f in files)
                    for k, v in want.items() if v or any(
                        k in f[3] for f in files)}
    if totals != want_checked:
        raise AssertionError(f"keras_small: checked {totals}, launched "
                             f"{want_checked}")
    emit("keras_small", files=rows, layers=layer_rows, tolerance=LAYER_TOL,
         launches=want_checked, plain_on_cuda=plain,
         launches_checked=_checked_summary(checked), card=card)
    kern.reset_counts()
    return want_checked, checked


def keras_import_phase(torch, np, card):
    """tf.keras's MobileNetV2 imported through KerasModelImport at full
    width, eagerly, every launch checked: the file written (keras_cases)
    and imported; forward at batch 32 in fp32 and bf16 against the exact
    path (features, logits, probabilities); an archive of it served over
    HTTP through ModelRouter.load; its training at batch 32 under
    Adam(1e-3) (a step under auto against exact with the gate's controls,
    four checked fp32 steps whose loss must fall, four checked bf16
    steps, images/sec, a profiled step each with the depthwise launches
    as their own class); the depthwise records at its ten geometries; the
    small leg (keras_small_phase). Returns the launches by part, the
    checks, the depthwise records and the state the captured leg starts
    from."""
    from deeplearning4j_tpu_torch.imports import KerasModelImport, keras_cases
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.tree import tree_leaves
    from deeplearning4j_tpu_torch.util import ModelSerializer

    launches, checked = {}, {}
    os.makedirs(KERAS_DIR, exist_ok=True)
    path = os.path.join(KERAS_DIR, "mobilenet_v2.h5")
    t0 = time.perf_counter()
    keras_cases.mobilenet_v2_h5(path, MNV2_INPUT, MNV2_CLASSES, 1.0,
                                MNV2_SEED)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(path,
                                                          device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_params = sum(int(t.numel()) for t in tree_leaves(
        {"p": net.params, "s": net.states}))
    want = expected_conv_launches(net.conf)
    classes = {}
    for n in net.topo:
        k = type(n.node).__name__
        classes[k] = classes.get(k, 0) + 1
    if n_params != MNV2_PARAMS or want != MNV2_STEP:
        raise AssertionError(f"imported MobileNetV2: {n_params} params "
                             f"(want {MNV2_PARAMS}), launches a step {want} "
                             f"(want {MNV2_STEP})")
    emit("keras_import_file", model="MobileNetV2", input=list(MNV2_INPUT),
         classes=MNV2_CLASSES, alpha=1.0, seed=MNV2_SEED,
         file_bytes=os.path.getsize(path), write_s=write_s,
         import_s=import_s, params_and_states=n_params,
         params=net.num_params(), nodes=classes,
         launches_per_step=want, card=card)

    # forward at batch 32 against the exact path, fp32 and bf16
    x, y = mobilenet_batch(torch, np)
    with kern.impl_scope("exact"):
        ff = net.feed_forward(x)
        feats_e = ff["global_average_pooling2d"].float()
        out_e = net.output(x).float()
        head = net.params["predictions"]
        logits_e = feats_e.double() @ head["W"].double() + head[
            "b"].double()
    del ff
    fwd = {}
    feats, out, logits, launches["forward"], checked["forward"] = \
        mobilenet_forward(torch, net, x, "fp32")
    fwd["fp32"] = {"features_err": _normalised(feats, feats_e),
                   "logits_err": _normalised(logits, logits_e),
                   "probabilities_err": _normalised(out, out_e)}
    net16 = copy_net(net, bf16_conf(net))
    feats, out, logits, launches["forward_bf16"], checked[
        "forward_bf16"] = mobilenet_forward(torch, net16, x, "bf16")
    fwd["bf16"] = {"features_err": _normalised(feats, feats_e),
                   "logits_err": _normalised(logits, logits_e),
                   "probabilities_err": _normalised(out, out_e)}
    del net16
    gates = {"fp32": KERAS_TOL, "bf16": LAYER_TOL["bf16"][0]}
    for tag, rec in fwd.items():
        if max(rec.values()) > gates[tag]:
            raise AssertionError(f"MobileNetV2 {tag} forward off exact: "
                                 f"{rec} (gate {gates[tag]})")
    emit("keras_import_forward", model="MobileNetV2", batch=MNV2_BATCH,
         errors=fwd, gates=gates, max_prob=float(out_e.max()),
         min_prob=float(out_e.min()),
         features_absmax=float(feats_e.abs().max()),
         logits_std=float(logits_e.std()),
         launches_checked={t: _checked_summary(checked[p])
                           for t, p in (("fp32", "forward"),
                                        ("bf16", "forward_bf16"))},
         card=card)
    emit("keras_import_throughput", model="MobileNetV2", batch=MNV2_BATCH,
         path="net.output", window_s=RATE_WINDOW_S,
         forward_images_per_sec_fp32=forward_rows_per_sec(
             torch, net, x, windows=ZOO_WINDOWS), card=card)

    # an archive of the imported net, served through ModelRouter.load
    archive = os.path.join(KERAS_DIR, "mobilenet_v2.zip")
    t0 = time.perf_counter()
    ModelSerializer.write_model(net, archive, save_updater=False)
    archive_s = time.perf_counter() - t0
    fields, launches["serve"], checked["serve"] = serve_and_check(
        torch, np, net, "mobilenet_v2", MNV2_INPUT, MNV2_STEP["conv2d_fwd"],
        archive=archive)
    emit("keras_import_serve", model="MobileNetV2", archive=archive,
         archive_bytes=os.path.getsize(archive), archive_write_s=archive_s,
         **fields, card=card)

    # trained at batch 32 under Adam(1e-3), fp32 and bf16 from one state
    tnet = mobilenet_trainable(torch, net)
    del net
    torch.cuda.empty_cache()
    proto = copy_net(tnet)
    got, chk = eager_train_leg(torch, card, "keras_import", "MobileNetV2",
                               tnet, copy_net(proto, bf16_conf(proto)), x,
                               y, MNV2_STEP, MNV2_STEPS, MNV2_STEPS)
    launches.update(got)
    checked.update(chk)
    conf = tnet.conf
    del tnet
    torch.cuda.empty_cache()
    records = depthwise_records(torch, conf, MNV2_DEPTHWISE, 17,
                                "keras_depthwise")
    launches["small"], checked["small"] = keras_small_phase(torch, np, card)
    kern.reset_counts()
    return launches, checked, records, proto, (x, y)


# ----------------------------------------------------- serialize, checkpoint

SER_DIR = os.path.join(ROOT, "build", "smoke_archives")
SER_LENET_TRAIN = 6400
SER_BUCKETS = (1, 2, 4)
SER_ROWS = (1, 3, 2)


def _state_tensors(net):
    from deeplearning4j_tpu_torch.util.model_serializer import jax_items

    return [t for tree in (net.params, net.states, net.opt_states)
            for _, t in jax_items(tree)]


def _bit_equal(a, b):
    return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y):
    return x.shape == y.shape and x.dtype == y.dtype and bool((x == y).all())


def _timed_ms(fn):
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def serialize_resnet(torch, np, tmp):
    """ResNet-50 fp32 with Adam after 2 captured fit steps at batch 32:
    archived with its updater, restored onto the card; its forward bit for
    bit the writer's, then 2 more steps of each bit for bit (losses,
    params, layer and optimizer states)."""
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    batch = 32
    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        np.random.default_rng(7).integers(0, 1000, batch)]).cuda()
    fit_losses(net, [(x, y)] * 2)
    path = os.path.join(tmp, "resnet50.zip")
    _, write_ms = _timed_ms(lambda: ModelSerializer.write_model(net, path))
    back, restore_ms = _timed_ms(
        lambda: ModelSerializer.restore_computation_graph(path))
    torch.cuda.synchronize()
    fwd_equal = torch_equal(back.output(x), net.output(x))
    la = torch.stack(fit_losses(net, [(x, y)] * 2))
    lb = torch.stack(fit_losses(back, [(x, y)] * 2))
    torch.cuda.synchronize()
    resume_equal = torch_equal(la, lb) and _bit_equal(
        _state_tensors(net), _state_tensors(back))
    rec = {"model": "ResNet50", "params": net.num_params(), "batch": batch,
           "updater": net.conf.updater, "archive_bytes":
           os.path.getsize(path), "write_ms": write_ms,
           "restore_ms": restore_ms, "restored_device": str(back.device),
           "forward_bit_equal": fwd_equal, "resume_bit_equal": resume_equal,
           "losses_writer": la.tolist(), "losses_restored": lb.tolist()}
    if not (fwd_equal and resume_equal) or back.device.type != "cuda":
        raise AssertionError(f"serialize ResNet-50: {rec}")
    return rec


def serialize_bert(torch, np, tmp):
    """BERT-base (max length 512) archived without its updater, served
    through ModelRouter.load over HTTP: each answer bit for bit what the
    writer's own ServingModel gives for the same rows; reload to an archive
    written after one fit step advances the version and the answers follow
    the new weights; a truncated archive's reload is refused and the old
    version keeps answering."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.serving import (ModelLoadError,
                                                  ModelRouter, ModelServer,
                                                  ServingModel)
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import Bert

    net = Bert.base(max_length=512).init(device="cuda")
    policy = BucketingPolicy(batch_buckets=SER_BUCKETS)
    p1, p2 = os.path.join(tmp, "bert_v1.zip"), os.path.join(tmp,
                                                            "bert_v2.zip")
    _, write_ms = _timed_ms(lambda: ModelSerializer.write_model(
        net, p1, save_updater=False))
    router = ModelRouter()
    _, load_ms = _timed_ms(lambda: router.load(
        "bert", p1, bucketing=policy, max_wait_ms=1.0, queue_limit=16))
    served, _ = router.get("bert")
    writer = ServingModel(net, "writer", bucketing=policy)
    server = ModelServer(router, port=0).start()
    url = f"{server.url}/v1/models/bert/infer"
    rng = np.random.default_rng(99)
    xs = [bert_rows(np, r, 512, rng) for r in SER_ROWS]

    def answers_equal():
        ok = True
        for x in xs:
            body, _ = _post(url, {"inputs": x.tolist()})
            got = np.asarray(body["outputs"], np.float64)
            want = writer.execute([x])[0][0].astype(np.float64)
            ok = ok and got.shape == want.shape and bool((got == want).all())
        return ok

    try:
        v1_equal = answers_equal()
        xt = bert_rows(np, 4, 512, rng)
        yt = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
        with capture.disabled():
            net.fit(xt, yt)
        ModelSerializer.write_model(net, p2, save_updater=False)
        version, reload_ms = _timed_ms(lambda: router.reload("bert", p2))
        v2_equal = answers_equal()
        bad = os.path.join(tmp, "bert_truncated.zip")
        with open(p2, "rb") as src, open(bad, "wb") as dst:
            dst.write(src.read()[:os.path.getsize(p2) // 2])
        try:
            router.reload("bert", bad)
            rejected = False
        except ModelLoadError:
            rejected = True
        still_equal = answers_equal()
    finally:
        server.stop()
    rec = {"model": "Bert.base", "seq": 512, "params": net.num_params(),
           "archive_bytes": os.path.getsize(p1), "write_ms": write_ms,
           "load_ms": load_ms, "reload_ms": reload_ms,
           "requests_rows": list(SER_ROWS), "buckets": list(SER_BUCKETS),
           "v1_answers_bit_equal": v1_equal, "version_after_reload": version,
           "v2_answers_bit_equal": v2_equal,
           "truncated_reload_rejected": rejected,
           "version_after_rejected_reload": served.version,
           "old_version_still_answers": still_equal}
    if not (v1_equal and v2_equal and rejected and still_equal
            and version == 2 and served.version == 2):
        raise AssertionError(f"serialize BERT: {rec}")
    return rec


def _mnist(n, train=True):
    """(features, one-hot labels) of ``n`` synthetic digits."""
    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator

    it = MnistDataSetIterator(batch=LENET_BATCH, n_examples=n, train=train)
    return it.features, it.labels


def serialize_lenet(torch, np, tmp):
    """LeNet: one fit(iterator) epoch on synthetic digits scaled to [-1, 1]
    under CheckpointListener(keep_last=2), exactly 2 archives left; the
    normalizer archived and restored; early stopping with a
    LocalFileModelSaver, the restored best model scoring exactly what the
    trainer reported."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
    from deeplearning4j_tpu_torch.data.normalizers import \
        ImagePreProcessingScaler
    from deeplearning4j_tpu_torch.nn.listeners import CheckpointListener
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet

    xtr, ytr = _mnist(SER_LENET_TRAIN)
    xte, yte = _mnist(1024, train=False)
    norm = ImagePreProcessingScaler(-1.0, 1.0, 1.0).fit(DataSet(xtr, ytr))
    xtr, xte = norm.normalize(xtr), norm.normalize(xte)
    ckdir = os.path.join(tmp, "lenet_ckpt")
    net = LeNet().init(device="cuda")
    lst = CheckpointListener(ckdir, save_every_n_iterations=25, keep_last=2)
    net.listeners.append(lst)
    net.fit(ArrayDataSetIterator(xtr, ytr, batch=LENET_BATCH))
    on_disk = sorted(os.listdir(ckdir))
    path = os.path.join(tmp, "lenet.zip")
    ModelSerializer.write_model(net, path, normalizer=norm)
    back_norm = ModelSerializer.restore_normalizer_from_file(path)
    norm_equal = back_norm.to_dict() == norm.to_dict()
    val = ArrayDataSetIterator(xte, yte, batch=LENET_BATCH)
    saver = es.LocalFileModelSaver(os.path.join(tmp, "lenet_es"))
    conf = (es.EarlyStoppingConfiguration.builder()
            .score_calculator(es.DataSetLossCalculator(val))
            .model_saver(saver)
            .epoch_termination_conditions(es.MaxEpochsTerminationCondition(2))
            .build())
    result = es.EarlyStoppingTrainer(
        conf, LeNet().init(device="cuda"),
        ArrayDataSetIterator(xtr, ytr, batch=LENET_BATCH)).fit()
    best = result.best_model
    score = es.DataSetLossCalculator(val).calculate_score(best)
    acc = best.evaluate(val).accuracy()
    rec = {"model": "LeNet", "steps": net.iteration,
           "checkpoints_on_disk": on_disk, "checkpoints_written":
           net.iteration // 25, "normalizer_restored": norm_equal,
           "early_stopping_epochs": result.total_epochs,
           "best_epoch": result.best_model_epoch,
           "best_score_reported": result.best_model_score,
           "best_score_restored": score, "best_accuracy": acc,
           "best_device": str(best.device)}
    if (len(on_disk) != 2 or not norm_equal
            or score != result.best_model_score
            or best.device.type != "cuda"):
        raise AssertionError(f"serialize LeNet: {rec}")
    return rec


def serialize_phase(torch, np, card):
    """ModelSerializer archives on the card: ResNet-50 restore and resume,
    BERT-base served from archives with a rolling reload, LeNet's
    checkpoint listener, normalizer and early stopping (the three
    serialize_* functions; their archives under the git-ignored build/,
    removed after)."""
    import gc
    import shutil

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SER_DIR, ignore_errors=True)
    os.makedirs(SER_DIR)
    try:
        recs = {"reserved_bytes_at_start": torch.cuda.memory_reserved()}
        for name, fn in (("resnet50", serialize_resnet),
                         ("bert", serialize_bert),
                         ("lenet", serialize_lenet)):
            t = time.perf_counter()
            recs[name] = fn(torch, np, SER_DIR)
            recs[name]["wall_s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(SER_DIR, ignore_errors=True)
    emit("serialize", **recs, card=card)
    return recs


class _FaultAt:
    """A listener that raises once, at ``iteration``."""

    def __init__(self, iteration):
        self.iteration, self.fired = iteration, False

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.iteration and not self.fired:
            self.fired = True
            raise RuntimeError("injected fault")


def checkpoint_phase(torch, np, card):
    """ShardedCheckpointer(keep=3) on LeNet fit, saving every step async:
    the newest step corrupted on disk, restore_latest_good returns the one
    before it, with the arrays that step saved; a FaultTolerantTrainer run
    stopped by a fault at the first step of its second epoch and resumed,
    its params, states, optimizer states and dropout generator bit for bit
    an uninterrupted run's."""
    import shutil

    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.util import (FaultTolerantTrainer,
                                               ShardedCheckpointer,
                                               ShardedCheckpointListener)
    from deeplearning4j_tpu_torch.util.checkpoint import load_tree_npz
    from deeplearning4j_tpu_torch.util.model_serializer import jax_items
    from deeplearning4j_tpu_torch.zoo import LeNet

    root = os.path.join(ROOT, "build", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    xtr, ytr = _mnist(1280)
    steps = len(xtr) // LENET_BATCH

    def it():
        return ArrayDataSetIterator(xtr, ytr, batch=LENET_BATCH)

    try:
        ckpt = ShardedCheckpointer(os.path.join(root, "a"), keep=3,
                                   log_fn=None)
        net = LeNet().init(device="cuda")
        net.listeners.append(ShardedCheckpointListener(ckpt, frequency=1,
                                                       block=False))
        t = time.perf_counter()
        net.fit(it())
        ckpt.wait_until_finished()
        fit_s = time.perf_counter() - t
        kept = ckpt.all_steps()
        newest = os.path.join(ckpt.directory, str(kept[-1]), "state.npz")
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) // 3)
        saved = load_tree_npz(os.path.join(ckpt.directory, str(kept[-2]),
                                           "state.npz"))
        fresh = LeNet().init(device="cuda")
        got = ckpt.restore_latest_good(fresh)
        arrays_equal = all(
            np.array_equal(t_.cpu().numpy(), np.asarray(s))
            for (_, t_), (_, s) in zip(jax_items(fresh.params),
                                       jax_items(saved["params"])))
        steady = LeNet().init(device="cuda")
        steady.fit(it(), epochs=2)
        faulty = LeNet().init(device="cuda")
        fault = _FaultAt(steps + 1)
        faulty.listeners.append(fault)
        trainer = FaultTolerantTrainer(faulty, os.path.join(root, "b"),
                                       checkpoint_every=1, keep=3)
        trainer.listener.block = False
        t = time.perf_counter()
        trainer.fit(it(), epochs=2)
        ft_s = time.perf_counter() - t
        torch.cuda.synchronize()
        resumed_equal = (faulty.iteration == steady.iteration
                         and _bit_equal(_state_tensors(faulty),
                                        _state_tensors(steady))
                         and torch_equal(faulty._gen.get_state(),
                                         steady._gen.get_state()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = {"model": "LeNet", "steps_per_epoch": steps, "keep": 3,
           "steps_kept": kept, "fit_with_async_saves_s": fit_s,
           "restored_step": got, "corrupt_skipped": ckpt.corrupt_skipped_total,
           "restored_arrays_equal_saved": arrays_equal,
           "fault_at_iteration": steps + 1, "fault_fired": fault.fired,
           "restarts": trainer.restarts, "fault_tolerant_fit_s": ft_s,
           "resumed_bit_equal_uninterrupted": resumed_equal}
    if (kept != [steps - 2, steps - 1, steps] or got != steps - 1
            or ckpt.corrupt_skipped_total != 1 or not arrays_equal
            or not fault.fired or trainer.restarts != 1
            or not resumed_equal):
        raise AssertionError(f"checkpoint: {rec}")
    emit("checkpoint", **rec, card=card)
    return rec


# --------------------------------------------------------------- SameDiff

SD_DIR = os.path.join(ROOT, "build", "smoke_samediff")
SD_TOL = 1e-4
SD_RESNET_BATCH, SD_RESNET_STEPS = 32, 4
SD_RESNET_STEP = {"conv2d_fwd": 53, "conv2d_dgrad": 52, "conv2d_wgrad": 53}
SD_LSTM = (32, 50, 47, 256)  # the char-RNN's B, T, inputs, H
SD_FIT_WINDOW_BATCHES = 4


class _StepLosses:
    """A SameDiff listener keeping each step's loss."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, sd, it, loss):
        self.losses.append(loss)


class _DataSets:
    """A list of DataSets as an iterator ``SameDiff.fit`` takes."""

    def __init__(self, sets):
        self.sets = list(sets)

    def __iter__(self):
        return iter(self.sets)

    def reset(self):
        pass


def _sd_values(torch, sd, feeds, dtype):
    """The graph's stored arrays and ``feeds`` on the card, floats as
    ``dtype`` (integers as they are)."""
    from deeplearning4j_tpu_torch.samediff import core

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    vals = {k: cast(v) for k, v in sd._device_arrays().items()}
    vals.update({k: cast(core._to_device(a, sd.device))
                 for k, a in feeds.items()})
    return vals


def _sd_run64(torch, sd, feeds, outs):
    """The same recorded nodes on the card in fp64."""
    from deeplearning4j_tpu_torch.samediff import core

    with torch.no_grad():
        return core._trace_nodes(sd._nodes, _sd_values(
            torch, sd, feeds, torch.float64), outs)


def _sd_grads64(torch, sd, feeds, names):
    """(loss, d(loss)/d(names)) of the graph on the card in fp64, as CPU
    tensors: the gradient gate's reference step."""
    vals = _sd_values(torch, sd, feeds, torch.float64)
    for n in names:
        vals[n] = vals[n].detach().requires_grad_(True)
    loss = sd._loss_value(vals)
    grads = torch.autograd.grad(loss, [vals[n] for n in names])
    return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}


def _sd_class(kernel, names):
    """Profile bucket of a device kernel of a SameDiff BERT step, by its
    name and the CPU ops it ran under."""
    if "multi_tensor_apply" in kernel or "foreach" in kernel:
        return "adam"
    if names & {"aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"}:
        return "matmul"
    if names & {"aten::_softmax", "aten::_softmax_backward_data",
                "aten::_log_softmax", "aten::_log_softmax_backward_data"}:
        return "softmax"
    if names & {"aten::index_select", "aten::index_add_",
                "aten::index_select_backward"}:
        return "gather"
    if names & {"aten::erf"}:
        return "gelu_erf"
    if names & {"aten::mean", "aten::rsqrt", "aten::sub", "aten::pow"}:
        return "layer_norm_parts"
    return "other"


def profile_samediff_step(torch, sd, ds):
    """One eager ``fit`` step of a SameDiff graph under torch.profiler:
    wall, device busy, idle share, device ms by :func:`_sd_class`."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import capture

    with capture.disabled():
        sd.fit(ds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)  # the tracer's warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sd.fit(ds)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    busy = sum(k[0] for k in kernels)
    by_class = {}
    for evt in prof.events():
        names = {evt.name} | {p.name for p in _parents(evt)}
        for k in evt.kernels:
            cls = _sd_class(k.name, names)
            by_class[cls] = by_class.get(cls, 0.0) + k.duration / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            **{f"{c}_ms": v for c, v in sorted(by_class.items())},
            **{f"{c}_share_of_busy": v / busy for c, v in by_class.items()
               if busy},
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:8]]}


def _no_kernels(kern, what):
    if any(kern.LAUNCHES.values()) or any(kern.PLAIN_ON_CUDA.values()):
        raise AssertionError(f"{what}: kernels {kern.LAUNCHES}, plain on "
                             f"CUDA {kern.PLAIN_ON_CUDA}")


def _bert_feeds(np, ds):
    """A BertIterator batch as the frozen BERT graph's three int32
    placeholders."""
    return {"input_ids": ds.features[..., 0].astype(np.int32),
            "input_mask": ds.features_mask.astype(np.int32),
            "segment_ids": ds.features[..., 1].astype(np.int32)}


def samediff_tf_bert_phase(torch, np, card):
    """BERT-base (hidden 768, 12 layers, 12 heads, FFN 3072, vocabulary
    30,522, 512 positions, 2 classes; seed 12345) written as a frozen TF
    GraphDef by ``graph_cases.bert_graph_def`` from the zoo net's params,
    imported from bytes: its probabilities at batch 32, S 128 against
    ``net.output`` (flash off) and against the same graph in fp64; every
    weight converted to a variable, a softmaxCrossEntropy head on a label
    placeholder, Adam(BERT_TRAIN_LR): the first step's gradients by the
    fp64 step gate, BERT_TRAIN_EPOCHS epochs of ``fit`` on the bert_train
    phase's batches (captured) with the last 10 steps' mean loss below
    the first 10's; SameDiff BERT samples/sec of ``output`` and ``fit``,
    eager and captured; one profiled eager step by class. Returns what
    samediff_save needs."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.imports import graph_cases, import_graph_def
    from deeplearning4j_tpu_torch.nlp import Vocab
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.zoo import Bert

    rec = {"model": "Bert.base", "batch": BERT_TRAIN_BATCH,
           "seq": BERT_TRAIN_SEQ}
    net = Bert.base(max_length=512, num_classes=2, hidden_dropout=0.0,
                    flash=False).init(device="cuda")
    t0 = time.perf_counter()
    gd, _ = graph_cases.bert_graph_def(net, BERT_TRAIN_SEQ)
    rec["graph_def_mb"] = len(gd) / 2 ** 20
    rec["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = import_graph_def(gd, device="cuda")
    rec["import_s"] = time.perf_counter() - t0
    del gd
    rec["nodes"], rec["arrays"] = len(sd._nodes), len(sd._arrays)
    text, labels = bert_corpus()
    batches = list(bert_iterator(Vocab.build(text), text, labels))
    feeds = [_bert_feeds(np, ds) for ds in batches]
    logits = sd.tf_name_map["logits:0"]
    probs = sd.tf_name_map["probabilities:0"]

    # (a) the forward against net.output and against fp64
    f0 = feeds[0]
    x, _, m = _ds_on_card(torch, batches[0])
    kern.reset_counts()
    with capture.disabled():
        out = sd.output(f0, [probs, logits])
        want = net.output(x, mask=m).double().cpu()
    torch.cuda.synchronize()
    _no_kernels(kern, "the imported BERT forward")
    r64 = [t.cpu() for t in _sd_run64(torch, sd, f0, [probs, logits])]
    got = torch.from_numpy(out[probs]).double()
    net_err, net_norm = _grad_error(got, want)
    p64_err, p64_norm = _grad_error(got, r64[0])
    l64_err, l64_norm = _grad_error(torch.from_numpy(out[logits]).double(),
                                    r64[1])
    rec.update(probs_vs_net_output=net_err, probs_vs_net_output_norm=net_norm,
               probs_vs_fp64=p64_err, logits_vs_fp64_norm=l64_norm,
               tol=SD_TOL)
    if max(net_norm, p64_norm, l64_norm) > SD_TOL:
        raise AssertionError(f"imported BERT forward: {rec}")
    del net, x, m, want
    torch.cuda.empty_cache()

    # (b) fine-tune: every weight a variable, a cross-entropy head
    weights = [n for n, a in sd._arrays.items()
               if a.dtype == np.float32 and a.ndim >= 1]
    sd.convert_to_variable(*weights)
    label = sd.placeholder("label", shape=(-1, 2))
    loss = sd.loss.softmaxCrossEntropy(sd.get_variable(logits), label)
    sd.set_loss_variables(loss)
    sd.set_training_config(TrainingConfig(
        updater=Adam(BERT_TRAIN_LR),
        data_set_feature_mapping=["input_ids", "input_mask", "segment_ids"],
        data_set_label_mapping=["label"]))
    rec["variables"] = len(weights)
    rec["parameters"] = int(sum(sd._arrays[n].size for n in weights))
    fl = dict(f0, label=batches[0].labels)
    with capture.disabled():
        g_auto = sd.calculate_gradients(fl, *weights)
        with kern.impl_scope("exact"):
            g_exact = sd.calculate_gradients(fl, *weights)
        l32 = sd.score(fl)
    l64, g_64 = _sd_grads64(torch, sd, fl, weights)

    def as_t(g):
        return {"sd": {k: torch.from_numpy(v) for k, v in g.items()}}

    (worst_name, worst), rows, failures = _grad_parity(
        as_t(g_auto), as_t(g_exact), {"sd": g_64}, top=None)
    loss_rel = abs(l32 - l64) / abs(l64)
    if loss_rel > TRAIN_LOSS_RTOL or failures:
        raise AssertionError(f"imported BERT step off fp64: loss rel "
                             f"{loss_rel}, gradients past the gate "
                             f"{failures[:4]}")
    rec.update(first_step_loss=l32, first_step_loss_fp64=l64,
               loss_rel_err=loss_rel, worst_grad=worst_name,
               worst_grad_auto_vs_exact=worst,
               max_gate_use=max(r["gate_use"] for r in rows),
               worst_gate_use=sorted(rows, key=lambda r: -r["gate_use"])[:3])
    del g_auto, g_exact, g_64, rows
    torch.cuda.empty_cache()

    # (c) the main path: fit on the bert_train batches, captured
    sets = [DataSet([f["input_ids"], f["input_mask"], f["segment_ids"]],
                    ds.labels) for f, ds in zip(feeds, batches)]
    steps = _StepLosses()
    sd.add_listener(steps)
    kern.reset_counts()
    t0 = time.perf_counter()
    hist = sd.fit(_DataSets(sets), epochs=BERT_TRAIN_EPOCHS)
    torch.cuda.synchronize()
    rec["fit_s"] = time.perf_counter() - t0
    _no_kernels(kern, "the imported BERT fit")
    sd._listeners.remove(steps)
    ls = steps.losses
    first, last = float(np.mean(ls[:10])), float(np.mean(ls[-10:]))
    if not np.isfinite(ls).all() or not last < first:
        raise AssertionError(f"imported BERT fit: first 10 {first}, last "
                             f"10 {last}")
    rec.update(fit_steps=len(ls), epoch_losses=hist, first10_mean=first,
               last10_mean=last, programs={
                   k: {"eager": p.eager, "captured": p.graph is not None,
                       "pool_mb": p.pool_bytes / 2 ** 20}
                   for k, p in sd.programs().items()})

    # (d) samples/sec, output and fit, eager and captured
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    window = _DataSets(sets[:SD_FIT_WINDOW_BATCHES])
    rows_fit = SD_FIT_WINDOW_BATCHES * BERT_TRAIN_BATCH
    with capture.disabled():
        rec["output_samples_per_sec_eager"] = captured_rate(
            torch, lambda: sd.output(f0, [probs]), BERT_TRAIN_BATCH)
        rec["fit_samples_per_sec_eager"] = captured_rate(
            torch, lambda: sd.fit(window), rows_fit)
    torch.cuda.empty_cache()
    rec["output_samples_per_sec_captured"] = captured_rate(
        torch, lambda: sd.output(f0, [probs]), BERT_TRAIN_BATCH)
    rec["fit_samples_per_sec_captured"] = captured_rate(
        torch, lambda: sd.fit(window), rows_fit)
    rec["profile_eager_step"] = profile_samediff_step(
        torch, sd, _DataSets(sets[:1]))
    emit("samediff_tf_bert", **rec, card=card)
    return sd, sets, f0, probs, logits


def samediff_save_phase(torch, np, card, sd, sets, f0, probs, logits):
    """``save`` (with the updater state) of the trained BERT-base graph and
    ``load`` on the card: arrays, the Adam moments and the iteration bit
    for bit, the outputs bit for bit the writer's (captured, and eager),
    and one more eager ``fit`` step on each under deterministic algorithms
    bit for bit (loss, every trainable, the moments)."""
    import shutil

    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.samediff import SameDiff
    from deeplearning4j_tpu_torch.util.model_serializer import jax_items

    shutil.rmtree(SD_DIR, ignore_errors=True)
    os.makedirs(SD_DIR)
    path = os.path.join(SD_DIR, "bert_base.sdz")
    rec = {}
    try:
        t0 = time.perf_counter()
        sd.save(path, save_updater_state=True)
        rec["save_s"] = time.perf_counter() - t0
        rec["file_mb"] = os.path.getsize(path) / 2 ** 20
        t0 = time.perf_counter()
        sd2 = SameDiff.load(path, device="cuda")
        rec["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(SD_DIR, ignore_errors=True)
    bad = [k for k in sd._arrays
           if not np.array_equal(sd._arrays[k], sd2._arrays[k])]
    moments = [torch_equal(a, b) for (_, a), (_, b) in zip(
        jax_items(sd._opt_state), jax_items(sd2._opt_state))]
    if bad or not all(moments) or sd._it_count != sd2._it_count:
        raise AssertionError(f"load: arrays off {bad[:4]}, moments equal "
                             f"{sum(moments)}/{len(moments)}, iterations "
                             f"{sd._it_count} vs {sd2._it_count}")
    outs = [s.output(f0, [probs, logits]) for s in (sd, sd2)]
    with capture.disabled():
        outs += [s.output(f0, [probs, logits]) for s in (sd, sd2)]
    for a in outs[1:]:
        for k in (probs, logits):
            if not np.array_equal(a[k], outs[0][k]):
                raise AssertionError(f"loaded graph's {k} differs")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with capture.disabled():
            hist = [s.fit(_DataSets(sets[:1])) for s in (sd, sd2)]
    finally:
        torch.use_deterministic_algorithms(False)
    bad = [n for n in sd.trainable_names()
           if not np.array_equal(sd._arrays[n], sd2._arrays[n])]
    moments = [torch_equal(a, b) for (_, a), (_, b) in zip(
        jax_items(sd._opt_state), jax_items(sd2._opt_state))]
    if hist[0] != hist[1] or bad or not all(moments):
        raise AssertionError(f"step after load: losses {hist}, trainables "
                             f"off {bad[:4]}, moments equal "
                             f"{sum(moments)}/{len(moments)}")
    rec.update(arrays=len(sd._arrays), updater_leaves=len(moments),
               it_count=sd2._it_count, outputs_bit_equal=True,
               step_loss=hist[0][0], step_bit_equal=True)
    emit("samediff_save", **rec, card=card)


def samediff_tf_resnet_phase(torch, np, card):
    """ResNet-50 (224x224x3, 1000 classes) as the frozen TF GraphDef of
    ``graph_cases.resnet50_graph_def`` (seed 12345), imported from bytes,
    at batch 32: the forward with its 53 K1 launches each checked and the
    answer within SD_TOL of the ``exact`` route's; the 53 conv kernels
    converted to variables, a softmaxCrossEntropy head, Adam(1e-3),
    SD_RESNET_STEPS eager ``fit`` steps each with its 53 / 52 / 53 K1 /
    dgrad / K3 launches checked and the loss falling; images/sec of the
    forward and of ``fit``, eager and captured, and a captured step's
    launches under replay. Returns the launches and checks."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.imports import graph_cases, import_graph_def
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.samediff import TrainingConfig

    rec = {"model": "ResNet50 (TF GraphDef)", "batch": SD_RESNET_BATCH}
    t0 = time.perf_counter()
    gd, names = graph_cases.resnet50_graph_def(seed=12345)
    sd = import_graph_def(gd, device="cuda")
    rec["graph_def_mb"], rec["import_s"] = (len(gd) / 2 ** 20,
                                            time.perf_counter() - t0)
    del gd
    logits = sd.tf_name_map[names["logits"] + ":0"]
    rng = np.random.default_rng(12345)
    x = rng.standard_normal((SD_RESNET_BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                    SD_RESNET_BATCH)]
    feeds = {names["input"]: x}
    checked = {}
    with capture.disabled():
        kern.reset_counts()
        with check_every_launch(torch, checked):
            out = sd.output(feeds, [logits])[logits]
        torch.cuda.synchronize()
        fwd = {k: v for k, v in kern.LAUNCHES.items() if v}
        if fwd != {"conv2d_fwd": 53} or any(kern.PLAIN_ON_CUDA.values()):
            raise AssertionError(f"imported ResNet-50 forward: {fwd}, plain "
                                 f"{kern.PLAIN_ON_CUDA}")
        with kern.impl_scope("exact"):
            ex = sd.output(feeds, [logits])[logits]
    err, norm = _grad_error(torch.from_numpy(out), torch.from_numpy(ex))
    if norm > SD_TOL or not np.isfinite(out).all():
        raise AssertionError(f"imported ResNet-50 vs exact: {norm}")
    rec.update(forward_launches=fwd, forward_vs_exact=err,
               forward_vs_exact_norm=norm,
               forward_checked=_checked_summary(checked))
    kernels = [n for n, a in sd._arrays.items() if a.ndim == 4]
    sd.convert_to_variable(*kernels)
    label = sd.placeholder("label", shape=(-1, 1000))
    loss = sd.loss.softmaxCrossEntropy(sd.get_variable(logits), label)
    sd.set_loss_variables(loss)
    sd.set_training_config(TrainingConfig(
        updater=Adam(1e-3), data_set_feature_mapping=[names["input"]],
        data_set_label_mapping=["label"]))
    ds = DataSet(x, y)
    losses, step_launches, train_checked = [], [], {}
    with capture.disabled():
        for _ in range(SD_RESNET_STEPS):
            kern.reset_counts()
            with check_every_launch(torch, train_checked):
                losses += sd.fit(ds)
            torch.cuda.synchronize()
            got = {k: v for k, v in kern.LAUNCHES.items() if v}
            if got != SD_RESNET_STEP or any(kern.PLAIN_ON_CUDA.values()):
                raise AssertionError(f"imported ResNet-50 step: {got}, plain "
                                     f"{kern.PLAIN_ON_CUDA}")
            step_launches.append(got)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"imported ResNet-50 fit losses {losses}")
    launches = {k: sum(s[k] for s in step_launches) for k in SD_RESNET_STEP}
    with capture.disabled():
        rec["forward_images_per_sec_eager"] = captured_rate(
            torch, lambda: sd.output(feeds, [logits]), SD_RESNET_BATCH)
        rec["fit_images_per_sec_eager"] = captured_rate(
            torch, lambda: sd.fit(ds), SD_RESNET_BATCH)
    rec["forward_images_per_sec_captured"] = captured_rate(
        torch, lambda: sd.output(feeds, [logits]), SD_RESNET_BATCH)
    rec["fit_images_per_sec_captured"] = captured_rate(
        torch, lambda: sd.fit(ds), SD_RESNET_BATCH)
    kern.reset_counts()
    sd.fit(ds)
    torch.cuda.synchronize()
    captured = {k: v for k, v in kern.LAUNCHES.items() if v}
    if captured != SD_RESNET_STEP:
        raise AssertionError(f"captured imported ResNet-50 step: {captured}")
    rec.update(fit_losses=losses, step_launches=step_launches[0],
               launches=launches, launches_captured_step=captured,
               train_checked=_checked_summary(train_checked),
               programs={k: {"eager": p.eager, "captured": p.graph is not None}
                         for k, p in sd.programs().items()})
    emit("samediff_tf_resnet", **rec, card=card)
    return {"forward": fwd, "fit": launches, "captured_step": captured,
            "forward_checked": checked, "fit_checked": train_checked}


def samediff_onnx_lstm_phase(torch, np, card):
    """The char-RNN's LSTM (47 -> 256, B 32, T 50, one-hot characters) as
    the ONNX model of ``graph_cases.lstm_onnx`` (seed 12345) on the card
    and on the CPU: ``output`` (K4 once) and, with W/R/B converted to
    variables and a mean-squared-error loss, ``calculate_gradients`` (K4
    once, its backward plain), every launch checked, eager and then
    captured (a replay's launches counted, not checked); the answer and
    the gradients within SD_TOL of the largest CPU value."""
    from deeplearning4j_tpu_torch.imports import graph_cases, import_onnx
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern

    b, t, n_in, h = SD_LSTM
    blob = graph_cases.lstm_onnx(seed=12345, input_size=n_in, hidden=h,
                                 batch=b, seq_len=t)
    rng = np.random.default_rng(12345)
    x = np.eye(n_in, dtype=np.float32)[rng.integers(0, n_in, (b, t))]
    target = rng.uniform(-0.5, 0.5, (b, t, h)).astype(np.float32)
    graphs = []
    for dev in ("cuda", "cpu"):
        sd = import_onnx(blob, device=dev)
        sd.convert_to_variable("W", "R", "B")
        tgt = sd.placeholder("target", shape=(b, t, h))
        sd.set_loss_variables(sd.loss.meanSquaredError(
            sd.get_variable("y"), tgt))
        graphs.append(sd)
    sd, cpu = graphs
    feeds = {"x": x, "target": target}
    want_y = cpu.output(feeds, ["y"])["y"]
    want_g = cpu.calculate_gradients(feeds, "W", "R", "B")
    rec, checked, launches = {"batch": b, "seq": t, "inputs": n_in,
                              "hidden": h}, {}, {}
    for mode in ("eager", "captured"):
        # eager: every launch checked; captured: the launches a replay
        # counts (a check reads values on the host, which no capture holds)
        ctx = capture.disabled() if mode == "eager" else \
            contextlib.nullcontext()
        check = (lambda: check_every_launch(torch, checked)) \
            if mode == "eager" else contextlib.nullcontext
        with ctx:
            kern.reset_counts()
            with check():
                y = sd.output(feeds, ["y"])["y"]
            torch.cuda.synchronize()
            n_out = dict(kern.LAUNCHES)
            kern.reset_counts()
            with check():
                g = sd.calculate_gradients(feeds, "W", "R", "B")
            torch.cuda.synchronize()
            n_grad = dict(kern.LAUNCHES)
        for what, n in (("output", n_out), ("gradients", n_grad)):
            got = {k: v for k, v in n.items() if v}
            if got != {"lstm_seq_fwd": 1} or any(kern.PLAIN_ON_CUDA.values()):
                raise AssertionError(f"ONNX LSTM {what} ({mode}): {got}")
            launches[f"{what}_{mode}"] = got["lstm_seq_fwd"]
        y_err, y_norm = _grad_error(torch.from_numpy(y),
                                    torch.from_numpy(want_y))
        g_norm = max(_grad_error(torch.from_numpy(g[k]),
                                 torch.from_numpy(want_g[k]))[1]
                     for k in want_g)
        if y_norm > SD_TOL or g_norm > SD_TOL:
            raise AssertionError(f"ONNX LSTM vs CPU ({mode}): y {y_norm}, "
                                 f"gradients {g_norm}")
        rec[mode] = {"y_vs_cpu_norm": y_norm, "y_vs_cpu": y_err,
                     "grads_vs_cpu_norm": g_norm}
    rec.update(launches=launches, checked=_checked_summary(checked),
               programs={k: {"eager": p.eager, "captured": p.graph is not None}
                         for k, p in sd.programs().items()})
    emit("samediff_onnx_lstm", **rec, card=card)
    return launches, checked


# ------------------------------------------------------------ data pipeline

DATA_DIR = os.path.join(ROOT, "build", "smoke_data")
JPEG_FIXTURES = os.path.join(ROOT, "tools", "fixtures", "jpeg")
DP_SHARDS, DP_CSV_COLS = 8, 785
DP_RATE_BATCHES = {"native_csv": 300, "csv_record_reader": 40}  # leg (a)'s
#                             rate windows: the first batches of an epoch
DP_CSV_RR_BATCHES = 250       # leg (a): the CSVRecordReader route's checked
#                               run, of the epoch's 938 batches (cut)
DP_IMAGES, DP_CLASSES, DP_IMAGE_BATCH = 512, 16, 32
DP_SEQ_BATCHES = 2            # leg (c): 2 batches of 64 reviews (cut)
DP_CSV_THREADS, DP_DECODE_THREADS = (1, 2, 4, 8), (1, 4, 8)
DP_STRESS = 200
DP_H2D_MB = 64
RESNET_STEP = {"conv2d_fwd": 53, "conv2d_wgrad": 53, "conv2d_dgrad": 52}


class MnistCsvPreProcessor:
    """DataSetPreProcessor: MNIST-format CSV features (784 pixels 0-255,
    flat) to NHWC (B, 28, 28, 1) in [0, 1]."""

    def pre_process(self, ds):
        ds.features = (ds.features / 255.0).astype(
            ds.features.dtype).reshape(-1, 28, 28, 1)


class Tee:
    """Iterates ``base`` and keeps each host batch it yields in ``kept``
    (the plain Python path's batches, before staging)."""

    def __init__(self, base):
        self.base, self.kept = base, []

    def reset(self):
        self.kept = []
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        for ds in self.base:
            self.kept.append(ds)
            yield ds


class CheckedBatches:
    """Iterates ``it`` (staged batches) and holds each one, on the card, bit
    for bit against ``plain(i)``, the plain Python path's i-th batch:
    features, labels and masks of the same type and shape and equal
    (``torch.equal`` after copying the plain batch over). Counts them."""

    def __init__(self, torch, it, plain):
        self.torch, self.it, self.plain, self.n = torch, it, plain, 0

    def reset(self):
        self.it.reset()

    def __iter__(self):
        torch = self.torch
        for i, ds in enumerate(self.it):
            want = self.plain(i)
            for f in ("features", "labels", "features_mask", "labels_mask"):
                a, b = getattr(ds, f), getattr(want, f)
                if (a is None) != (b is None):
                    raise AssertionError(f"batch {i} {f}: {a is None} / "
                                         f"{b is None} None")
                if a is None:
                    continue
                if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
                    raise AssertionError(f"batch {i} {f} not staged on the "
                                         f"card: {type(a)}")
                bt = torch.from_numpy(b).to(a.device)
                if a.dtype != bt.dtype or a.shape != bt.shape or \
                        not torch.equal(a, bt):
                    raise AssertionError(
                        f"batch {i} {f}: staged {a.dtype} "
                        f"{tuple(a.shape)} differs from the plain path's "
                        f"{bt.dtype} {tuple(bt.shape)}")
            self.n += 1
            yield ds


class FirstBatches:
    """The first ``n`` batches of ``it``, as an iterator ``fit`` takes."""

    def __init__(self, it, n):
        self.it, self.n = it, n

    def reset(self):
        self.it.reset()

    def __iter__(self):
        return itertools.islice(iter(self.it), self.n)


def write_png(path, arr):
    """``arr`` (H, W) or (H, W, 3) uint8 as a PNG, with the standard
    library's zlib (no PIL on the card's host)."""
    import struct

    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             0 if arr.ndim == 2 else 2,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def smooth_image(np, rng, h, w):
    """A smooth seeded RGB field in [0, 255] (sinusoids and blobs), as
    tools/make_jpeg_fixtures.py draws its fixtures."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2) * np.pi / np.array([h, w])
        ph = rng.uniform(0, 2 * np.pi, 2)
        img[..., c] = 128 + 60 * np.sin(yy * fy + ph[0]) * np.cos(
            xx * fx + ph[1])
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(20, 80)
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += g[..., None] * rng.uniform(-90, 90, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def mnist_csv_arrays(np, x, y):
    """The synthetic digits as the CSV shards hold them: (pixels rounded
    to 0-255 as uint8 (n, 784), labels (n,))."""
    return np.rint(x.reshape(len(x), -1) * 255).astype(np.uint8), y.argmax(1)


def write_mnist_csv(np, x, y):
    """The synthetic digits as MNIST-format CSV shards (label, then the
    784 pixels rounded to 0-255), DP_SHARDS files. → (paths, bytes)."""
    pix, lab = mnist_csv_arrays(np, x, y)
    table = [str(i) for i in range(256)]
    paths, nbytes = [], 0
    for k, idx in enumerate(np.array_split(np.arange(len(x)), DP_SHARDS)):
        text = "\n".join(f"{lab[i]}," + ",".join([table[v] for v in
                                                  pix[i].tolist()])
                         for i in idx) + "\n"
        p = os.path.join(DATA_DIR, f"mnist_train_{k}.csv")
        with open(p, "w") as f:
            f.write(text)
        paths.append(p)
        nbytes += len(text)
    return paths, nbytes


def write_image_tree(np):
    """DP_IMAGES images in DP_CLASSES class folders under DATA_DIR/images:
    half PNGs written here with zlib (seeded smooth fields, 256-500 px a
    side), half copies of the committed JPEG fixtures. → (root, bytes)."""
    import shutil

    root = os.path.join(DATA_DIR, "images")
    rng = np.random.default_rng(12345)
    jpegs = sorted(os.path.join(JPEG_FIXTURES, f)
                   for f in os.listdir(JPEG_FIXTURES))
    nbytes = 0
    for i in range(DP_IMAGES):
        d = os.path.join(root, f"class{i % DP_CLASSES:02d}")
        os.makedirs(d, exist_ok=True)
        if i % 2:
            p = os.path.join(d, f"img{i:04d}.jpg")
            shutil.copyfile(jpegs[(i // 2) % len(jpegs)], p)
        else:
            h, w = (int(v) for v in rng.integers(256, 501, 2))
            p = os.path.join(d, f"img{i:04d}.png")
            img = smooth_image(np, rng, h, w)
            write_png(p, img[..., 0] if i % 8 == 0 else img)
        nbytes += os.path.getsize(p)
    return root, nbytes


def write_reviews(np):
    """DP_SEQ_BATCHES x SENT_BATCH reviews as CSVSequenceRecordReader
    files (one a review; SENT_FEATURES values, N(0, 1) to 3 decimals, and
    the label a row; 32-256 rows; the label the sign of the review's mean
    projected on a seeded unit vector, as review_batches draws it).
    → (dir, bytes)."""
    d = os.path.join(DATA_DIR, "reviews")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(12345)
    u = rng.normal(size=SENT_FEATURES)
    u /= np.linalg.norm(u)
    table = {k: f"{k / 1000:.3f}" for k in range(-6000, 6001)}
    nbytes = 0
    for i in range(DP_SEQ_BATCHES * SENT_BATCH):
        n = int(rng.integers(SENT_MIN_LEN, SENT_MAX_LEN + 1))
        q = np.clip(np.rint(rng.normal(size=(n, SENT_FEATURES)) * 1000),
                    -6000, 6000).astype(int)
        cls = int(q.mean(0) @ u > 0)
        rows = "\n".join(",".join([table[v] for v in r]) + f",{cls}"
                         for r in q.tolist()) + "\n"
        p = os.path.join(d, f"review_{i:04d}.csv")
        with open(p, "w") as f:
            f.write(rows)
        nbytes += len(rows)
    return d, nbytes


def dp_rates(torch, np, native, paths, csv_bytes, csv_rows, image_paths):
    """CSV parse MB/s and rows/s by thread count, native image decode
    images/s by thread count, pinned (and pageable) H2D GB/s."""
    parse = {}
    for n in DP_CSV_THREADS:
        t0 = time.perf_counter()
        pipe = native.AsyncCSVPipeline(paths, cols=DP_CSV_COLS, n_threads=n,
                                       prefetch=4)
        rows = sum(len(a) for _, a in pipe)
        pipe.close()
        s = time.perf_counter() - t0
        if rows != csv_rows:
            raise AssertionError(f"CSV pipeline at {n} threads: {rows} rows")
        parse[n] = {"seconds": s, "mb_per_s": csv_bytes / s / 1e6,
                    "rows_per_s": rows / s}
    decode = {}
    for n in DP_DECODE_THREADS if image_paths else ():
        t0 = time.perf_counter()
        pipe = native.AsyncImagePipeline(image_paths, height=224, width=224,
                                         channels=3, batch=DP_IMAGE_BATCH,
                                         n_threads=n, prefetch=64,
                                         pin_memory=False)
        count = sum(len(x) for x, _, _ in pipe)
        pipe.close()
        s = time.perf_counter() - t0
        if count != len(image_paths) or pipe.failed:
            raise AssertionError(f"image pipeline at {n} threads: {count} "
                                 f"images, {pipe.failed} failed")
        decode[n] = {"seconds": s, "images_per_s": count / s}
    h2d = {}
    n = DP_H2D_MB * (1 << 20) // 4
    dst = torch.empty(n, device="cuda")
    for kind in ("pinned", "pageable"):
        src = torch.ones(n, pin_memory=kind == "pinned")
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        h2d[kind] = {"gb_per_s": 10 * src.nbytes / (
            start.elapsed_time(end) / 1e3) / 1e9, "mb": DP_H2D_MB}
    return parse, decode, h2d


def dp_stress(np, native):
    """DP_STRESS pipelines of 4 files (50 seeded MNIST-width rows each, the
    last without a final newline), 4 threads, a ring of 1: each must
    deliver every file in order, equal to the single-threaded parse."""
    rng = np.random.default_rng(5)
    paths4 = []
    for k in range(4):
        p = os.path.join(DATA_DIR, f"stress_{k}.csv")
        with open(p, "w") as f:
            f.write("\n".join(",".join(str(v) for v in row) for row in
                              rng.integers(0, 256, (50, DP_CSV_COLS))))
        paths4.append(p)
    want = []
    for p in paths4:
        with open(p, "rb") as f:
            want.append(native.parse_csv(f.read(), DP_CSV_COLS))
    t0 = time.perf_counter()
    for k in range(DP_STRESS):
        pipe = native.AsyncCSVPipeline(paths4, cols=DP_CSV_COLS, n_threads=4,
                                       prefetch=1)
        got = list(pipe)
        pipe.close()
        if [i for i, _ in got] != list(range(len(paths4))) or not all(
                np.array_equal(a, want[i]) for i, a in got):
            raise AssertionError(f"stress pipeline {k}: files "
                                 f"{[i for i, _ in got]} or rows differ")
    return {"pipelines": DP_STRESS, "files": len(paths4), "threads": 4,
            "prefetch": 1, "seconds": time.perf_counter() - t0}


class Clocked:
    """Iterates ``it`` and notes when ``fit`` asked for its second batch
    (the first step dispatched) and the rows of the batches from there on
    (the window after start-up)."""

    def __init__(self, it):
        self.it, self.t_first, self.rest_rows = it, None, 0

    def reset(self):
        if hasattr(self.it, "reset"):
            self.it.reset()

    def __iter__(self):
        for i, ds in enumerate(self.it):
            if i:
                self.rest_rows += len(ds.features)
            yield ds
            if i == 0:
                self.t_first = time.perf_counter()


def fit_rate(torch, net, data, rows):
    """``net.fit(data)`` once, closed by a device sync: rows a second over
    the whole call, and over the window from the first step's dispatch to
    the end (the rows of the later batches: the rate after start-up, which
    leaves out the first batch's read, the iterator's threads' start and
    the first step)."""
    clock = Clocked(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(clock)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = t1 - t0
    if not math.isfinite(net.get_score()):
        raise AssertionError(f"non-finite loss {net.get_score()}")
    after = t1 - clock.t_first
    return {"rows_per_s": rows / s, "seconds": s, "rows": rows,
            "after_first_rows_per_s": clock.rest_rows / after,
            "after_first_seconds": after, "first_step_s": clock.t_first - t0}


def rate_record(eager, resident, captured, resident_c):
    """A leg's four fit rates and the iterator's share of the resident
    rate, eager and captured, over the whole call and after start-up."""
    out = {"eager": eager, "resident_eager": resident, "captured": captured,
           "resident_captured": resident_c}
    for mode, it, res in (("eager", eager, resident),
                          ("captured", captured, resident_c)):
        out[f"{mode}_over_resident"] = it["rows_per_s"] / res["rows_per_s"]
        out[f"{mode}_over_resident_after_first"] = (
            it["after_first_rows_per_s"] / res["after_first_rows_per_s"])
    return out


def profile_window(torch, run):
    """``run()`` under torch.profiler: wall, device busy (the traced
    kernels' sum; the staging copies apart) and idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer's warm-up kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(torch, prof)
    copies = sum(ms for ms, _, k in kernels if k.startswith("Memcpy"))
    busy = sum(ms for ms, _, k in kernels if not k.startswith("Memcpy"))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "h2d_copy_ms": copies,
            "top": [{"ms": ms, "calls": n, "kernel": k[:90]}
                    for ms, n, k in kernels[:6]]}


def checked_epoch(torch, net, data, want, steps, what):
    """One epoch of ``net.fit(data)`` eagerly with every launch checked:
    ``want`` launches a step, ``steps`` steps, none plain. → (launches,
    checks, scores, seconds)."""
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.nn import listeners as lst
    from deeplearning4j_tpu_torch.ops import kernels as kern

    collect = lst.CollectScoresListener(1)
    net.set_listeners(collect)
    checked = {}
    kern.reset_counts()
    t0 = time.perf_counter()
    with capture.disabled(), check_every_launch(torch, checked):
        net.fit(data)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    net.set_listeners()
    launches = {k: v for k, v in kern.LAUNCHES.items() if v}
    plain = {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v}
    expect = {k: v * steps for k, v in want.items()}
    tag = "bf16" if net.conf.compute_dtype == "bfloat16" else "fp32"
    if launches != expect or plain or _launch_summary(checked, tag) != expect:
        raise AssertionError(f"{what}: launched {launches}, expected "
                             f"{expect}; plain on CUDA {plain}; checked "
                             f"{_checked_summary(checked)}")
    scores = [v for _, v in collect.scores]
    if len(scores) != steps or not all(math.isfinite(v) for v in scores):
        raise AssertionError(f"{what}: {len(scores)} scores for {steps} "
                             f"steps, or non-finite")
    return launches, checked, scores, s


def data_lenet_leg(torch, np, card, paths, arrays):
    """Leg (a): LeNet-5 (seed 12345, Adam 1e-3) trained on the 60,000
    MNIST-format CSV rows, each route in AsyncDataSetIterator, every staged
    batch held bit for bit against the batch made with numpy from
    ``arrays`` (the pixels and labels the shards were written from):
    CSVRecordReader -> RecordReaderDataSetIterator (the plain Python path)
    for its first DP_CSV_RR_BATCHES batches (a cut: its parse runs at
    ~2,300 rows/s, 26 s for the epoch), its host batches also equal to
    numpy's, and NativeCSVDataSetIterator for the whole epoch, each a
    checked eager run. Then fit(iterator) images/sec over the route's
    first DP_RATE_BATCHES batches, eager and captured, beside one resident
    batch's; the captured epoch's programs (the ragged last batch of 32 is
    a second signature); a profiled window."""
    from deeplearning4j_tpu_torch.data import AsyncDataSetIterator, DataSet
    from deeplearning4j_tpu_torch.datavec import (CSVRecordReader,
                                                  RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.native.dataset import \
        NativeCSVDataSetIterator
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.util import telemetry as tm
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    pix, lab = arrays
    eye = np.eye(10, dtype=np.float32)
    pre = MnistCsvPreProcessor()

    def plain(i):
        rows = slice(i * LENET_BATCH, (i + 1) * LENET_BATCH)
        ds = DataSet(pix[rows].astype(np.float32), eye[lab[rows]])
        pre.pre_process(ds)
        return ds

    dev = torch.device("cuda")
    epoch = -(-LENET_TRAIN // LENET_BATCH)
    routes = {
        "csv_record_reader": lambda: RecordReaderDataSetIterator(
            CSVRecordReader(paths), LENET_BATCH, label_index=0,
            num_classes=10, preprocessor=MnistCsvPreProcessor()),
        "native_csv": lambda: NativeCSVDataSetIterator(
            paths, LENET_BATCH, DP_CSV_COLS, label_index=0, num_classes=10,
            n_threads=4, prefetch=4, preprocessor=MnistCsvPreProcessor()),
    }
    launches, checks, rates = {}, {}, {}
    for route, make in routes.items():
        steps = DP_CSV_RR_BATCHES if route == "csv_record_reader" else epoch
        base = Tee(make())
        it = AsyncDataSetIterator(base, device=dev)
        chk = CheckedBatches(torch, it, plain)
        net = LeNet().init(device="cuda")
        launches[route], checks[route], scores, s = checked_epoch(
            torch, net, FirstBatches(chk, steps), LENET_STEP, steps,
            f"LeNet via {route}")
        if chk.n != steps or it.staged_batches < steps:
            raise AssertionError(f"{route}: {chk.n} batches checked, "
                                 f"{it.staged_batches} staged, {steps} steps")
        for i, ds in enumerate(base.kept[:steps]):
            want = plain(i)
            if not (np.array_equal(ds.features, want.features)
                    and np.array_equal(ds.labels, want.labels)
                    and ds.features.dtype == want.features.dtype):
                raise AssertionError(f"{route}: host batch {i} differs "
                                     "from numpy's")
        first50, last50 = sum(scores[:50]) / 50, sum(scores[-50:]) / 50
        if last50 >= first50:
            raise AssertionError(f"LeNet via {route}: loss did not fall "
                                 f"({first50} -> {last50})")
        window = DP_RATE_BATCHES[route]
        rows = window * LENET_BATCH
        tm.get_telemetry().reset()
        with capture.disabled():
            eager_rate = fit_rate(torch, net, FirstBatches(
                AsyncDataSetIterator(make(), device=dev), window), rows)
        snap = tm.get_telemetry().snapshot()
        stalls = {"stalls_total": snap["counters"].get(
            "prefetch.stalls_total", 0.0), "stall_seconds":
            snap["histograms"].get("prefetch.stall_seconds")}
        ds = next(iter(AsyncDataSetIterator(make(), device=dev)))
        with capture.disabled():
            resident = fit_rate(torch, net, [ds] * window, rows)
        netc = LeNet().init(device="cuda")
        before = watcher_counts(None)
        t0 = time.perf_counter()
        if route == "native_csv":  # a whole epoch: the ragged last batch
            netc.fit(AsyncDataSetIterator(make(), device=dev))
        else:
            netc.fit(FirstBatches(AsyncDataSetIterator(make(), device=dev),
                                  5))
        torch.cuda.synchronize()
        built = watcher_counts(before)
        build_s = time.perf_counter() - t0
        captured = fit_rate(torch, netc, FirstBatches(
            AsyncDataSetIterator(make(), device=dev), window), rows)
        resident_c = fit_rate(torch, netc, [ds] * window, rows)
        rates[route] = rate_record(eager_rate, resident, captured,
                                   resident_c)
        if route == "native_csv":
            programs = built["traces"].get("MultiLayerNetwork.train_step", 0)
            if programs != 2:
                raise AssertionError(f"the captured LeNet epoch built "
                                     f"{programs} programs, expected 2 "
                                     "(batches of 64 and the last of 32)")
            rates[route]["captured_epoch"] = {"programs": programs,
                                              "seconds": build_s,
                                              **built}
            with capture.disabled():
                prof = profile_window(torch, lambda: net.fit(FirstBatches(
                    AsyncDataSetIterator(make(), device=dev), 100)))
        emit("data_pipeline_lenet", route=route, model="LeNet",
             batch=LENET_BATCH, steps=steps, epoch_steps=epoch,
             rows=steps * LENET_BATCH if steps < epoch else LENET_TRAIN,
             batches_checked_bit_equal=chk.n, staged=it.staged_batches,
             staged_bytes=it.staged_bytes, checked_epoch_s=s,
             loss_first50=first50, loss_last50=last50,
             launches=launches[route],
             launches_checked=_checked_summary(checks[route]),
             images_per_sec=rates[route], prefetch=stalls, card=card)
        del net, netc
    emit("data_pipeline_lenet_profile", route="native_csv", batches=100,
         **prof, card=card)
    return launches, checks, rates


def data_resnet_leg(torch, np, card, root):
    """Leg (b): ResNet-50 (224x224x3, 1000 classes, seed 12345,
    Adam(1e-3)) trained on the DP_IMAGES files through
    AsyncImageDataSetIterator (native decode and resize) ->
    AsyncDataSetIterator, fp32 and bf16: one checked epoch each on one
    decode thread (file order), every batch bit-equal to
    ``decode_image_file`` called file by file; then fit(iterator)
    images/sec on 8 decode threads, eager and captured, beside one
    resident batch's."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator, DataSet,
                                               AsyncImageDataSetIterator)
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    dev = torch.device("cuda")
    steps = DP_IMAGES // DP_IMAGE_BATCH

    def make(threads):
        return AsyncImageDataSetIterator(
            root=root, height=224, width=224, channels=3,
            batch=DP_IMAGE_BATCH, num_classes=1000, n_threads=threads,
            prefetch=64)

    items = make(1).items
    eye = np.eye(1000, dtype=np.float32)

    def plain(i):
        part = items[i * DP_IMAGE_BATCH:(i + 1) * DP_IMAGE_BATCH]
        x = np.stack([native.decode_image_file(p, 224, 224, 3)
                      for p, _ in part])
        x *= np.float32(1.0 / 255.0)
        return DataSet(x, eye[[lab for _, lab in part]])

    launches, checks, out = {}, {}, {}
    for tag, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        net = ResNet50(compute_dtype=dtype).init(device="cuda")
        _calm_residual_branches(net)
        src = make(1)
        it = AsyncDataSetIterator(src, device=dev)
        chk = CheckedBatches(torch, it, plain)
        launches[tag], checks[tag], scores, s = checked_epoch(
            torch, net, chk, RESNET_STEP, steps, f"ResNet-50 {tag} images")
        ring = src.pipeline.ring
        if (chk.n != steps or it.staged_batches != steps
                or src.decoded != DP_IMAGES or src.failed or ring is None
                or ring.fresh):
            raise AssertionError(
                f"ResNet-50 {tag}: {chk.n} batches checked, "
                f"{it.staged_batches} staged, {src.decoded} decoded natively "
                f"({src.failed} failed), ring {ring and ring.fresh} fresh")
        if scores[-1] >= scores[0]:
            raise AssertionError(f"ResNet-50 {tag}: loss did not fall "
                                 f"{scores}")
        rows = DP_IMAGES
        with capture.disabled():
            eager_rate = fit_rate(torch, net, AsyncDataSetIterator(
                make(8), device=dev), rows)
        ds = next(iter(AsyncDataSetIterator(make(8), device=dev)))
        with capture.disabled():
            resident = fit_rate(torch, net, [ds] * steps, rows)
        net.fit(AsyncDataSetIterator(make(8), device=dev))  # capture
        torch.cuda.synchronize()
        captured = fit_rate(torch, net, AsyncDataSetIterator(make(8),
                                                             device=dev),
                            rows)
        resident_c = fit_rate(torch, net, [ds] * steps, rows)
        out[tag] = rate_record(eager_rate, resident, captured, resident_c)
        emit("data_pipeline_resnet50", dtype=tag, model="ResNet50",
             batch=DP_IMAGE_BATCH, steps=steps, images=DP_IMAGES,
             classes_on_disk=DP_CLASSES, batches_checked_bit_equal=chk.n,
             staged=it.staged_batches, native_decodes=src.decoded,
             ring={"slots": len(ring.slots), "fresh": ring.fresh,
                   "waits": ring.waits},
             checked_epoch_s=s, losses=scores, launches=launches[tag],
             launches_checked=_checked_summary(checks[tag]),
             images_per_sec=out[tag],
             peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
             card=card)
        del net, ds
        torch.cuda.empty_cache()
    return launches, checks, out


def data_sentiment_leg(torch, np, card, seq_dir):
    """Leg (c): the sentiment graph "last" (LSTM 300 -> 256 on K4,
    RnnOutputLayer, Adam SENT_LR) trained on the review files through
    CSVSequenceRecordReader -> SequenceRecordReaderDataSetIterator (padded,
    with masks) -> AsyncDataSetIterator: one checked epoch in align_start,
    then one in align_end, on one net (the loss falls over the four
    steps), every staged batch bit-equal to the host batch; fit(iterator)
    sequences/sec eager and captured (seq_buckets) beside one resident
    batch's."""
    from deeplearning4j_tpu_torch.data import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.datavec import (
        CSVSequenceRecordReader, SequenceRecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.nn import capture

    dev = torch.device("cuda")

    def make(align):
        return SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(seq_dir), SENT_BATCH, label_index=-1,
            num_classes=2, alignment_mode=align)

    net = sent_graph("last")
    launches, checks, losses, kept = {}, {}, [], {}
    for align in ("align_start", "align_end"):
        base = Tee(make(align))
        it = AsyncDataSetIterator(base, device=dev)
        chk = CheckedBatches(torch, it, lambda i: base.kept[i])
        launches[align], checks[align], scores, _ = checked_epoch(
            torch, net, chk, {"lstm_seq_fwd": 1}, DP_SEQ_BATCHES,
            f"sentiment {align}")
        m = base.kept[0].features_mask
        lens = m.sum(1)
        edge = m[np.argmin(lens)]
        if (align == "align_end") != (edge[0] == 0 and edge[-1] == 1):
            raise AssertionError(f"{align}: the shortest review's mask "
                                 f"{edge[:3]}...{edge[-3:]}")
        losses += scores
        kept[align] = base.kept
        if chk.n != DP_SEQ_BATCHES or it.staged_batches != DP_SEQ_BATCHES:
            raise AssertionError(f"sentiment {align}: {chk.n} checked")
    if losses[-1] >= losses[0]:
        raise AssertionError(f"sentiment loss did not fall: {losses}")
    rows = DP_SEQ_BATCHES * SENT_BATCH
    with capture.disabled():
        eager_rate = fit_rate(torch, net, AsyncDataSetIterator(
            make("align_start"), device=dev), rows)
    staged = list(AsyncDataSetIterator(kept["align_start"], device=dev))
    with capture.disabled():
        resident = fit_rate(torch, net, staged, rows)
    netc = sent_graph("last", seq_buckets=SENT_SEQ_BUCKETS)
    before = watcher_counts(None)
    netc.fit(staged)  # builds the captured programs
    built = watcher_counts(before)
    captured = fit_rate(torch, netc, AsyncDataSetIterator(
        make("align_start"), device=dev), rows)
    resident_c = fit_rate(torch, netc, staged, rows)
    rates = {**rate_record(eager_rate, resident, captured, resident_c),
             "captured_programs": built}
    emit("data_pipeline_sentiment", graph="last", batch=SENT_BATCH,
         batches=DP_SEQ_BATCHES, reviews=rows, features=SENT_FEATURES,
         units=SENT_UNITS, losses=losses, launches=launches,
         launches_checked={k: _checked_summary(v) for k, v in checks.items()},
         sequences_per_sec=rates, card=card)
    return launches, checks, rates


def data_pipeline_phase(torch, np, card):
    """The host data pipeline (build, parse, decode, H2D, the three legs,
    the stress loop, the executor forked after CUDA). Returns the legs'
    launches and checks."""
    import ctypes.util
    import shutil

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datavec import (
        MultiProcessTransformExecutor, Schema, TransformProcess)

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    libs = {"jpeglib.h": os.path.exists("/usr/include/jpeglib.h")
            or os.path.exists("/usr/include/x86_64-linux-gnu/jpeglib.h"),
            "png.h": os.path.exists("/usr/include/png.h"),
            "libjpeg": ctypes.util.find_library("jpeg"),
            "libpng": ctypes.util.find_library("png16")
            or ctypes.util.find_library("png"),
            "g++": shutil.which("g++")}
    info = native.build_info()
    if info["error"] is not None:
        raise AssertionError(f"the native library did not build: "
                             f"{info['error']}")
    have_image_libs = all(libs.values())
    if have_image_libs and not info["image"]:
        raise AssertionError(f"the image decoder did not build where its "
                             f"libraries are: {info['image_error']}")
    emit("data_pipeline_build", seconds=info["seconds"],
         library=os.path.basename(info["library"]), image=info["image"],
         image_error=info["image_error"], host_libraries=libs, card=card)

    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator

    t0 = time.perf_counter()
    if "train" not in DIGITS:  # the lenet phase did not run before
        mn = MnistDataSetIterator(batch=LENET_BATCH, n_examples=LENET_TRAIN)
        DIGITS["train"] = (mn.features, mn.labels)
    paths, csv_bytes = write_mnist_csv(np, *DIGITS["train"])
    image_root, image_bytes = (write_image_tree(np) if info["image"]
                               else (None, 0))
    seq_dir, seq_bytes = write_reviews(np)
    image_paths = sorted(os.path.join(dp, f) for dp, _, fs in
                         os.walk(image_root) for f in fs) if image_root \
        else []
    emit("data_pipeline_files", csv_shards=len(paths), csv_rows=LENET_TRAIN,
         csv_mb=csv_bytes / 1e6, images=len(image_paths),
         image_mb=image_bytes / 1e6, reviews=DP_SEQ_BATCHES * SENT_BATCH,
         review_mb=seq_bytes / 1e6, write_s=time.perf_counter() - t0,
         cache="warm: the files were just written", card=card)

    parse, decode, h2d = dp_rates(torch, np, native, paths, csv_bytes,
                                  LENET_TRAIN, image_paths)
    stress = dp_stress(np, native)
    torch.cuda.init()
    tp = (TransformProcess.builder(
        Schema.builder().add_column_double("v").build())
        .double_math_op("v", "multiply", 2.0).build())
    recs = [[float(i)] for i in range(4096)]
    t0 = time.perf_counter()
    if MultiProcessTransformExecutor(tp, num_workers=4).execute(recs) != \
            tp.execute(recs):
        raise AssertionError("the forked executor differs from serial")
    fork = {"workers": 4, "records": len(recs),
            "seconds": time.perf_counter() - t0,
            "cuda_initialised_before": torch.cuda.is_initialized()}
    emit("data_pipeline_host", csv_parse=parse, image_decode=decode,
         h2d=h2d, stress=stress, fork_after_cuda=fork, card=card)

    launches, checks = {}, {}
    lenet = data_lenet_leg(torch, np, card, paths,
                           mnist_csv_arrays(np, *DIGITS["train"]))
    launches["lenet"], checks["lenet"] = lenet[0], lenet[1]
    if info["image"]:
        resnet = data_resnet_leg(torch, np, card, image_root)
        launches["resnet50"], checks["resnet50"] = resnet[0], resnet[1]
    else:
        emit("data_pipeline_resnet50", ran=False,
             reason="the native image decoder did not build on this host "
                    "(its libjpeg and libpng headers and libraries are "
                    "missing), so leg (b) waits for a host that has them",
             image_error=info["image_error"], host_libraries=libs,
             card=card)
    sent = data_sentiment_leg(torch, np, card, seq_dir)
    launches["sentiment"], checks["sentiment"] = sent[0], sent[1]
    return launches, checks


# --------------------------------------------------------------- generate

GEN_SEED = 12345
GEN_BUCKETS = (1, 2, 4, 8, 16, 32)
GEN_SEQ_BUCKETS = (64, 128, 256)  # max_length (512) is the implicit last
GEN_BLOCK = 16
GEN_POOL_BLOCKS = 1024  # + the trash block: 1,025 blocks, 16,400 slots
GEN_MAXLEN = 512
#: the HTTP wave: (prompt lengths of one request, max_new_tokens)
GEN_REQUESTS = (((16,), 32), ((48, 200), 48), ((448,), 64),
                ((64, 96, 128), 32), ((300, 17, 256, 80), 40), ((130,), 64),
                ((20, 400), 48), ((256, 33, 77), 32))
GEN_PREFIX = 256       # the prefix cache's shared head
GEN_STREAMS = 32       # streams sharing it, in two batches of 16
GEN_CHUNK = 64
GEN_SPEC_TOKENS = 4
GEN_RATE_BATCHES = (1, 8, 32)
GEN_RATE_PROMPT = 256  # + GEN_RATE_NEW generated: contexts to 512
GEN_RATE_NEW = 256
GEN_TTFT = (256, 448)
TIE_RTOL = 1e-4
GEN_DIR = os.path.join(ROOT, "build", "smoke_generate")


def gen_prompts(np, lengths, seed, vocab=30522):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in rng.integers(0, vocab, n)] for n in lengths]


def near_tie(logits_row, rtol=TIE_RTOL):
    """Whether the top two of a logits row are within ``rtol`` relative."""
    top = sorted(float(v) for v in logits_row)[-2:]
    return abs(top[1] - top[0]) <= rtol * max(abs(top[1]), 1e-6)


def tied_rows(torch, gen, prompts, got, want, oracle_logits=None):
    """Rows of ``got`` that differ from ``want`` where the tie rule allows
    it: at the first difference the oracle's top-two logits (its prefill
    over the prompt and the tokens before it, or ``oracle_logits[k][row]``
    from ``generate_full_recompute``) are within TIE_RTOL relative. Raises
    on any other difference, or when more than one row in 32 needs the
    rule."""
    ties = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        k = next((j for j in range(min(len(g), len(w))) if g[j] != w[j]),
                 None)
        if k is None:
            raise AssertionError(f"row {i}: {len(g)} tokens, {len(w)} "
                                 "expected")
        if oracle_logits is not None:
            row = oracle_logits[k][i]
        else:
            tokens, lengths, _, _ = gen._prep([list(prompts[i]) + w[:k]], 1)
            row = gen._prefill(tokens, lengths)[0].cpu().numpy()
        if not near_tie(row):
            raise AssertionError(f"row {i} differs at step {k} without a "
                                 f"near tie: {g[:k + 2]} vs {w[:k + 2]}")
        ties += 1
    if len(got) != len(want) or ties > max(1, len(got) // 32):
        raise AssertionError(f"{ties} rows of {len(got)} needed the tie "
                             "rule")
    return ties


def _http_generate(url, prompts, max_new, **extra):
    body, lat = _post(url, {"prompt_tokens": [list(p) for p in prompts],
                            "max_new_tokens": max_new, **extra})
    return body["tokens"], lat


def _http(url, method="GET", body=None, headers=None, timeout=600):
    """(status, body, headers) of one request, HTTP errors included; a
    JSON body is decoded, any other returned as text. ``body`` may be
    bytes already encoded."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return status, json.loads(raw), hdrs
    return status, raw.decode(), hdrs


def decode_rates(torch, np, gen, capture):
    """Decode tokens/sec at GEN_RATE_BATCHES, prompts of GEN_RATE_PROMPT
    and GEN_RATE_NEW new tokens (contexts to 512), captured and eager:
    (wall of the whole generate less the wall of a 1-token generate, the
    prefill's) per generated step, captured the median of 3, eager one run
    (host-bound and 3-12x slower; cut from the median of 3 to keep the
    whole smoke inside its limit)."""
    out = {}
    for b in GEN_RATE_BATCHES:
        prompts = gen_prompts(np, [GEN_RATE_PROMPT] * b, 100 + b)
        for mode in ("captured", "eager"):
            ctx = (capture.disabled() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx:
                gen.generate(prompts, max_new_tokens=2)  # build / warm
                walls = {}
                reps = 3 if mode == "captured" else 1
                for n in (1, GEN_RATE_NEW):
                    ts = []
                    for _ in range(reps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        gen.generate(prompts, max_new_tokens=n)
                        ts.append(time.perf_counter() - t0)
                    walls[n] = sorted(ts)[len(ts) // 2]
            decode_s = walls[GEN_RATE_NEW] - walls[1]
            out[f"b{b}_{mode}"] = {
                "tokens_per_s": b * (GEN_RATE_NEW - 1) / decode_s,
                "ms_per_step": decode_s / (GEN_RATE_NEW - 1) * 1e3,
                "prefill_wall_ms": walls[1] * 1e3,
                "generate_wall_s": walls[GEN_RATE_NEW]}
    return out


def time_to_first_token(torch, np, gen):
    out = {}
    for n in GEN_TTFT:
        prompts = gen_prompts(np, [n], 200 + n)
        gen.generate(prompts, max_new_tokens=1)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(prompts, max_new_tokens=1)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        out[f"prompt_{n}"] = {"median_ms": ts[2] * 1e3, "min_ms": ts[0] * 1e3,
                              "max_ms": ts[-1] * 1e3}
    return out


def graph_ms(torch, fn, reps=20):
    """Device time of one ``fn()`` by CUDA graph replay: ``reps`` calls
    captured in one graph, timed by events, per call."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms_of(torch, fn, reps=10):
    """Device time of one ``fn()`` (a program's replay) by CUDA events
    around ``reps`` back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _decode_class(name):
    n = name.lower()
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n \
            or n.startswith("sm90") or "ampere" in n or "splitk" in n:
        return "matmul"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather_scatter"
    if "softmax" in n:
        return "softmax"
    return "rest"


def profile_decode_step(torch, np, gen, batch=32):
    """One captured paged decode step at ``batch`` streams of 512-token
    contexts under torch.profiler: device time by kernel class (GEMMs, the
    gathers and scatters, softmax, the rest), its wall and idle share; and
    beside it, by CUDA graph replay, the step, the step's K/V gathers alone
    (2 per layer) and its attentions alone (``paged_attention`` per layer,
    gathers included), so the gather's and the attention's shares of the
    step stand apart from the kernel names."""
    from deeplearning4j_tpu_torch.ops import attention as att

    prompts = gen_prompts(np, [GEN_RATE_PROMPT] * batch, 300)
    tokens, lengths, b_real, lens = gen._prep(prompts, GEN_RATE_NEW)
    tables_list, tables, _, _, _ = gen._admit(lens, GEN_RATE_NEW, batch)
    try:
        limits = lengths + GEN_RATE_NEW - 1
        cur = gen._prefill_paged(tokens, lengths, tables).argmax(-1)
        positions = lengths + GEN_RATE_NEW // 2

        def step():
            gen._decode_paged(tables, cur, positions, limits)

        prof = profile_captured_step(torch, step)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as p:
            step()
            torch.cuda.synchronize()
        classes = {}
        for ms, n, name in device_kernels(torch, p):
            c = _decode_class(name)
            classes[c] = classes.get(c, 0.0) + ms
        slots = gen._slots_of(tables)
        pools = gen.pool.pools
        heads, dh = pools[0]["k"].shape[1], pools[0]["k"].shape[2]
        q = torch.randn((batch, heads, 1, dh), device="cuda")
        pos_w = positions[:, None]

        def gathers():
            for p_ in pools:
                att.paged_kv_gather(p_["k"], slots)
                att.paged_kv_gather(p_["v"], slots)

        def attentions():
            for p_ in pools:
                att.paged_attention(q, p_["k"], p_["v"], slots, pos_w)

        step_ms = events_ms_of(torch, step, reps=10)
        gather_ms = graph_ms(torch, gathers, reps=5)
        attention_ms = graph_ms(torch, attentions, reps=5)
        gathered = 2 * len(pools) * batch * GEN_MAXLEN * heads * dh * 4
    finally:
        gen.pool.release(tables_list)
    return {"batch": batch, "context": GEN_MAXLEN, **prof,
            "traced_classes_ms": classes,
            "step_ms_graph": step_ms, "gather_ms_graph": gather_ms,
            "attention_ms_graph": attention_ms,
            "gather_share": gather_ms / step_ms,
            "attention_share": attention_ms / step_ms,
            "attention_less_gather_share": (attention_ms - gather_ms)
            / step_ms,
            "gathered_bytes": gathered,
            "gather_GBps": gathered / (gather_ms * 1e-3) / 1e9,
            "per": "step_ms_graph: one replay of the step's program, by "
                   "events around 10; gather_ms_graph/attention_ms_graph: "
                   "one call by CUDA graph replay (5 in one graph); the "
                   "gathers "
                   "are the step's 2 per layer of (B, 512, 12, 64) fp32 "
                   "rows, the attentions its paged_attention per layer "
                   "(gathers included); traced_classes_ms: the profiled "
                   "replay's kernels by name"}


def prefix_cache_check(torch, np, net, kw):
    """GEN_STREAMS streams sharing a GEN_PREFIX-token head, two batches of
    16, through a prefix-cache generator and a cacheless one: tokens under
    the tie rule, the hit rate, and the blocks each run held at the end of
    each batch (read just before the batch releases them)."""
    from deeplearning4j_tpu_torch.serving import Generator

    head = gen_prompts(np, [GEN_PREFIX], 7)[0]
    tails = gen_prompts(np, [16 + (i * 7) % 33 for i in range(GEN_STREAMS)],
                        8)
    prompts = [head + t for t in tails]
    half = GEN_STREAMS // 2
    out = {}
    for name, extra in (("cache", {"prefix_cache": True}), ("plain", {})):
        gen = Generator(net, **kw, **extra)
        held = []
        release = gen.pool.release

        def recording(tables, gen=gen, release=release, held=held):
            held.append(gen.pool.num_blocks - gen.pool.free_blocks())
            return release(tables)

        gen.pool.release = recording
        toks, stats = [], []
        t0 = time.perf_counter()
        for part in (prompts[:half], prompts[half:]):
            st = {}
            toks += gen.generate(part, max_new_tokens=32, stats=st)
            stats.append(st)
        torch.cuda.synchronize()
        out[name] = {"tokens": toks, "blocks_held": held,
                     "wall_s": time.perf_counter() - t0,
                     "stats": [{k: v for k, v in s.items()
                                if k != "resumed_positions"} for s in stats],
                     "hit_rate": gen.prefix_hit_rate(), "gen": gen}
    c, p = out["cache"], out["plain"]
    ties = tied_rows(torch, p["gen"], prompts, c["tokens"], p["tokens"])
    if not c["gen"].pool.conservation()[0] or not c["gen"].cache.check()[0]:
        raise AssertionError("prefix cache: pool or trie inconsistent")
    if c["blocks_held"][1] >= p["blocks_held"][1]:
        raise AssertionError(f"prefix cache held {c['blocks_held']} blocks, "
                             f"the plain run {p['blocks_held']}")
    return {"streams": GEN_STREAMS, "prefix": GEN_PREFIX,
            "tails": [len(t) for t in tails], "max_new_tokens": 32,
            "hit_rate": c["hit_rate"],
            "batch_hit_rates": [s.get("prefix_hit_rate") for s in c["stats"]],
            "prefill_chunks": [s.get("prefill_chunks") for s in c["stats"]],
            "blocks_held_cache": c["blocks_held"],
            "blocks_held_plain": p["blocks_held"],
            "wall_s_cache": c["wall_s"], "wall_s_plain": p["wall_s"],
            "tie_rows": ties}


def int8_generate_check(torch, np, net, kw, tmp):
    """int8 decode: first-step logits within INT8_LOGIT_TOL of fp32,
    resident weight bytes against fp32, and an int8 archive written,
    loaded by ModelRouter.load(quantize="int8") with its int8 leaves
    bit-equal to the archive's, and decoding."""
    import zipfile

    from deeplearning4j_tpu_torch.serving import (INT8_LOGIT_TOL, Generator,
                                                  ModelRouter)
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer

    g8, g32 = Generator(net, quantize="int8", **kw), Generator(net, **kw)
    prompts = gen_prompts(np, (16, 300, 448), 9)
    tokens, lengths, b_real, _ = g8._prep(prompts, 1)
    tables = torch.zeros((tokens.shape[0], g8.pool.max_blocks_per_stream),
                         dtype=torch.int64, device="cuda")
    l8 = g8._prefill_paged(tokens, lengths, tables)[:b_real].clone()
    l32 = g32._prefill_paged(tokens, lengths, tables)[:b_real].clone()
    err = float((l8 - l32).abs().max())
    ratio = g8._qp.fp32_bytes() / g8._qp.resident_bytes()
    if err > INT8_LOGIT_TOL or ratio < 3.5:
        raise AssertionError(f"int8: logits err {err} (gate "
                             f"{INT8_LOGIT_TOL}), fp32/resident {ratio}")
    top1 = float((l8.argmax(-1) == l32.argmax(-1)).float().mean())
    resident, fp32 = g8._qp.resident_bytes(), g8._qp.fp32_bytes()
    del g8, g32
    path = os.path.join(tmp, "bert_base_causal_int8.zip")
    t0 = time.perf_counter()
    ModelSerializer.write_model(net, path, quantize="int8")
    write_s = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        z = np.load(__import__("io").BytesIO(zf.read("coefficients.npz")))
        written = [z[f"arr_{i}"] for i in range(len(z.files))]
    router = ModelRouter()
    try:
        t0 = time.perf_counter()
        router.load("lm8", path, kind="generate", quantize="int8",
                    start=False, **{k: v for k, v in kw.items()
                                    if k in ("block_size", "max_length")})
        load_s = time.perf_counter() - t0
        model, _ = router.get("lm8")
        loaded = [q.cpu().numpy() for q in model._qp.qleaves]
        if len(loaded) != len(written) or not all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(loaded, written)):
            raise AssertionError("int8 leaves served differ from the "
                                 "archive's")
        toks, _ = model.execute([np.asarray(prompts[0])], max_new_tokens=8)
        if len(toks[0]) != 8:
            raise AssertionError(f"int8 archive model decoded {toks}")
    finally:
        router.shutdown()
    return {"first_step_max_abs_logit_err": err, "tol": INT8_LOGIT_TOL,
            "first_step_top1_agreement": top1,
            "weight_bytes_resident": resident, "weight_bytes_fp32": fp32,
            "fp32_over_resident": ratio,
            "archive_bytes": os.path.getsize(path),
            "archive_write_s": write_s, "archive_load_s": load_s,
            "int8_leaves_bit_equal": True}


def generate_phase(torch, np, card):
    """Phase 22i: the decode tier at full width (module doc)."""
    import shutil

    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (Generator, ModelRouter,
                                                  ModelServer, ServingModel)
    from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher
    from deeplearning4j_tpu_torch.zoo import Bert

    t_phase = time.perf_counter()
    shutil.rmtree(GEN_DIR, ignore_errors=True)
    os.makedirs(GEN_DIR)
    net = Bert.base(causal=True, task="mlm", max_length=GEN_MAXLEN,
                    hidden_dropout=0.0, seed=GEN_SEED).init(device="cuda")
    policy = BucketingPolicy(batch_buckets=GEN_BUCKETS,
                             seq_buckets=GEN_SEQ_BUCKETS)
    kw = dict(batch_buckets=GEN_BUCKETS, prefill_buckets=GEN_SEQ_BUCKETS,
              block_size=GEN_BLOCK, max_length=GEN_MAXLEN)
    watcher = get_watcher()
    kern.reset_counts()

    # -- HTTP: ModelServer -> router -> scheduler -> ServingModel(generate)
    router = ModelRouter()
    model = ServingModel(net, "bert_base_lm", kind="generate",
                         bucketing=policy, block_size=GEN_BLOCK,
                         pool_blocks=GEN_POOL_BLOCKS, max_length=GEN_MAXLEN)
    router.register(model, max_wait_ms=20.0, queue_limit=64)
    small = ServingModel(net, "bert_base_lm_small_pool", kind="generate",
                         bucketing=BucketingPolicy(batch_buckets=(1, 2),
                                                   seq_buckets=(64,)),
                         block_size=GEN_BLOCK, pool_blocks=8,
                         max_length=GEN_MAXLEN)
    router.register(small, max_wait_ms=1.0)
    t0 = time.perf_counter()
    with watcher.scope() as warm:
        server = ModelServer(router, port=0).start()
    warm_s, warm_programs = time.perf_counter() - t0, warm.traces
    gen = model.generator
    requests = [(gen_prompts(np, lens, 1000 + i), n)
                for i, (lens, n) in enumerate(GEN_REQUESTS)]
    url = f"{server.url}/v1/models/bert_base_lm/generate"
    try:
        t1 = time.perf_counter()
        with watcher.scope() as steady, ThreadPoolExecutor(4) as pool:
            served = list(pool.map(lambda r: _http_generate(url, *r),
                                   requests[:4]))
            served += list(pool.map(lambda r: _http_generate(url, *r),
                                    requests[4:]))
        serve_s = time.perf_counter() - t1
        steady_programs = steady.traces
        served_tokens = [s[0] for s in served]
        _, sched = router.get("bert_base_lm")
        batches = sched.counts["batches"]
        # pool exhaustion: a pinned 8-block pool sheds a 200 + 32 request
        small_url = f"{server.url}/v1/models/bert_base_lm_small_pool/generate"
        status, body, headers = _http(small_url, "POST", {
            "prompt_tokens": gen_prompts(np, [200], 5), "max_new_tokens": 32})
        _, small_sched = router.get("bert_base_lm_small_pool")
        conserved = small.generator.pool.conservation()
        status2, body2, _ = _http(small_url, "POST", {
            "prompt_tokens": gen_prompts(np, [16], 6), "max_new_tokens": 32})
        shed = {"status": status, "error": body.get("error"),
                "retry_after": headers.get("Retry-After"),
                "shed_pool_exhausted": small_sched.counts[
                    "shed_pool_exhausted"],
                "conservation_after": conserved,
                "next_status": status2,
                "next_tokens": len(body2.get("tokens", [[]])[0])}
        if status != 429 or not headers.get("Retry-After") \
                or not conserved[0] or status2 != 200 \
                or shed["next_tokens"] != 32:
            raise AssertionError(f"pool exhaustion: {shed}")
    finally:
        server.stop()
    if steady_programs:
        raise AssertionError(f"the warmed server built {steady_programs} "
                             "programs for mixed context lengths")
    if any(kern.LAUNCHES.values()):
        raise AssertionError(f"the decode path launched kernels: "
                             f"{dict(kern.LAUNCHES)}")

    # -- the oracle, and the other engines on the same prompts
    ties = {}
    oracle = []
    t2 = time.perf_counter()
    for (prompts, n), got in zip(requests, served_tokens):
        lo = []
        want = gen.generate_full_recompute(prompts, n, logits_out=lo)
        oracle.append((want, lo))
    oracle_s = time.perf_counter() - t2

    def check(name, outs):
        ties[name] = sum(tied_rows(torch, gen, p, o, w, lo)
                         for (p, _), o, (w, lo) in zip(requests, outs,
                                                       oracle))

    check("http", served_tokens)
    contiguous = Generator(net, paged=False, **kw)
    check("contiguous", [contiguous.generate(p, n) for p, n in requests])
    chunked = Generator(net, prefill_chunk=GEN_CHUNK, **kw)
    chunk_stats = []

    def chunked_run(p, n):
        st = {}
        out = chunked.generate(p, n, stats=st)
        chunk_stats.append(st["prefill_chunks"])
        return out

    check("chunked", [chunked_run(p, n) for p, n in requests])
    del chunked
    draft = Bert.draft(vocab_size=30522, max_length=GEN_MAXLEN,
                       seed=7).init(device="cuda")
    spec = Generator(net, draft_net=draft, spec_tokens=GEN_SPEC_TOKENS, **kw)
    spec_stats = []

    def spec_run(gen_, p, n):
        st = {}
        out = gen_.generate(p, n, stats=st)
        spec_stats.append((st["spec_accept_rate"], st["spec_rounds"]))
        return out

    t3 = time.perf_counter()
    check("speculative", [spec_run(spec, p, n) for p, n in requests])
    spec_s = time.perf_counter() - t3
    del spec
    self_spec = Generator(net, draft_net=net, spec_tokens=GEN_SPEC_TOKENS,
                          **kw)
    self_stats_from = len(spec_stats)
    sub = requests[:2]
    outs = [spec_run(self_spec, p, n) for p, n in sub]
    ties["self_draft"] = sum(tied_rows(torch, gen, p, o, w, lo)
                             for (p, _), o, (w, lo) in zip(sub, outs,
                                                           oracle[:2]))
    self_rates = [r for r, _ in spec_stats[self_stats_from:]]
    # a self-draft accepts every proposal; the tie rule's budget (one in
    # 32) covers a near tie that rounds apart between the draft's one-row
    # step and the target's window
    if min(self_rates) < 1.0 - 1.0 / 32:
        raise AssertionError(f"a self-draft rejected proposals: {self_rates}")
    del self_spec
    # temperature: paged and contiguous draw the same samples from a seed
    sampled_rows = differing = 0
    for i, (p, n) in enumerate(requests[:4]):
        a = gen.generate(p, n, temperature=0.8, key=50 + i)
        b = contiguous.generate(p, n, temperature=0.8, key=50 + i)
        sampled_rows += len(a)
        differing += sum(x != y for x, y in zip(a, b))
    if differing > max(1, sampled_rows // 32):
        raise AssertionError(f"sampled paged/contiguous differ in "
                             f"{differing} of {sampled_rows} rows")
    del contiguous
    torch.cuda.empty_cache()
    prefix = prefix_cache_check(torch, np, net, kw)
    torch.cuda.empty_cache()
    int8 = int8_generate_check(torch, np, net, kw, GEN_DIR)
    torch.cuda.empty_cache()
    if any(kern.LAUNCHES.values()):
        raise AssertionError(f"the decode engines launched kernels: "
                             f"{dict(kern.LAUNCHES)}")
    # -- rates, time to first token, the profiled step
    rate_gen = Generator(net, **kw)
    rates = decode_rates(torch, np, rate_gen, capture)
    ttft = time_to_first_token(torch, np, rate_gen)
    step = profile_decode_step(torch, np, rate_gen)
    pool_fields = {"pool_blocks": gen.pool.num_blocks,
                   "pool_blocks_with_trash": gen.pool.num_blocks + 1,
                   "pool_slots": gen.pool.num_slots,
                   "pool_bytes": gen.pool.pool_bytes(),
                   "pool_bytes_with_trash": gen.pool.num_slots
                   * gen.pool.bytes_per_token(),
                   "bytes_per_token": gen.pool.bytes_per_token(),
                   "contiguous_stream_ceiling":
                   gen.pool.contiguous_stream_ceiling()}
    fields = {
        "model": "Bert.base(causal=True, task='mlm')", "seed": GEN_SEED,
        "params": net.num_params(), "max_length": GEN_MAXLEN,
        "batch_buckets": list(GEN_BUCKETS),
        "prefill_buckets": list(GEN_SEQ_BUCKETS) + [GEN_MAXLEN],
        "block_size": GEN_BLOCK, **pool_fields,
        "warmup_s": warm_s, "warmup_programs": warm_programs,
        "requests": [{"prompts": [len(x) for x in p], "max_new_tokens": n}
                     for p, n in requests],
        "http_batches": batches, "http_wall_s": serve_s,
        "http_latency_s": [lat for _, lat in served],
        "programs_after_warmup": steady_programs,
        "kernel_launches": sum(kern.LAUNCHES.values()),
        "oracle_wall_s": oracle_s, "tie_rule_rows": ties,
        "rows_compared": sum(len(p) for p, _ in requests),
        "chunked_prefill_chunks": chunk_stats,
        "speculative_accept_rates": [r for r, _ in
                                     spec_stats[:self_stats_from]],
        "speculative_rounds": [r for _, r in spec_stats[:self_stats_from]],
        "speculative_wall_s": spec_s,
        "self_draft_accept_rates": self_rates,
        "sampled_rows": sampled_rows, "sampled_rows_differing": differing,
        "pool_exhaustion": shed, "prefix_cache": prefix, "int8": int8,
        "decode_rates": rates, "time_to_first_token": ttft,
        "profiled_decode_step": step,
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit("generate", **fields)
    return 0


def serve_int8_leg(torch, np, card):
    """Leg serve_int8 of phase 22i: full-width ResNet-50 served with
    quantize="int8" over HTTP, every K1 launch checked, the answers against
    the same net with its params set to the dequantized leaves on the
    plain path; the largest probability difference from fp32 serving and
    the top-1 agreement beside them."""
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import QuantizedParams
    from deeplearning4j_tpu_torch.tree import tree_copy_
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    deq = ResNet50().init(device="cuda")  # the dequantized leaves' net
    qp = QuantizedParams.from_params(net.params).device_put("cuda")
    tree_copy_(deq.params, qp.rebuild())
    tree_copy_(deq.states, net.states)
    fields, launches, checked = serve_and_check(
        torch, np, net, "resnet50_int8", (224, 224, 3), 53,
        quantize="int8", ref_net=deq)
    rng = np.random.default_rng(12345)
    x = torch.from_numpy(rng.integers(-8, 9, size=(16, 224, 224, 3)).astype(
        np.float32) / 4).cuda()
    with kern.impl_scope("exact"):
        p32 = net.output(x)
        p8 = deq.output(x)
    emit("serve_int8", model="ResNet50", quantize="int8", input=[224, 224, 3],
         **fields, weight_bytes_resident=qp.resident_bytes(),
         weight_bytes_fp32=qp.fp32_bytes(),
         quantized_fraction=qp.quantized_fraction(),
         max_prob_diff_vs_fp32=float((p8 - p32).abs().max()),
         top1_agreement_vs_fp32=float(
             (p8.argmax(-1) == p32.argmax(-1)).float().mean()),
         rows_vs_fp32=16, card=card)
    return launches, checked


# ------------------------------------------------ serving resilience (22j)

RES_DIR = os.path.join(ROOT, "build", "smoke_resilience")
RES_COOLDOWN_S = 5.0       # the breaker's cooldown, on its own clock
RES_SLOW_MS = 1500.0       # serving_slow_batch's stall
RES_DEADLINE_MS = 200.0    # the deadline of the requests queued behind it
RELOAD_SEED = 7            # the second ResNet-50's weights (watch, reload)
SERVE_TOL = 1e-4           # a served answer against the exact path


def quarter_grid(np, rng, rows, shape=(224, 224, 3)):
    """``rows`` inputs of ``shape`` on a quarter grid in [-2, 2] (short
    JSON, exact in fp32)."""
    return rng.integers(-8, 9, size=(rows,) + tuple(shape)).astype(
        np.float32) / 4


def served_errors(np, answers):
    """The largest difference of the 200 answers from their nets' outputs
    on the exact path (plain conv), and the answers' count."""
    from deeplearning4j_tpu_torch.ops import kernels as kern

    worst = 0.0
    for x, got, net in answers:
        with kern.impl_scope("exact"):
            ref = net.output(x).double().cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"answer {got.shape}, expected {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
    if worst > SERVE_TOL:
        raise AssertionError(f"served answers off by {worst} > {SERVE_TOL}")
    return worst, len(answers)


def _wait(cond, timeout_s, what, poll_s=0.05):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(poll_s)


def serving_resilience_phase(torch, np, card):
    """Phase 22j: the single-process resilience of the serving stack at full
    width, eager (module doc)."""
    import shutil

    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (BrownoutController,
                                                  CircuitBreaker, ModelRouter,
                                                  ModelServer, ServingModel)
    from deeplearning4j_tpu_torch.util import ModelSerializer, slo
    from deeplearning4j_tpu_torch.util import faults as fl
    from deeplearning4j_tpu_torch.util import telemetry as tm
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    os.makedirs(RES_DIR)
    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    net2 = ResNet50(seed=RELOAD_SEED).init(device="cuda")
    _calm_residual_branches(net2)
    live = os.path.join(RES_DIR, "live.zip")
    ModelSerializer.write_model(net, live, save_updater=False)
    clock = [0.0]
    breaker = CircuitBreaker(clock=lambda: clock[0], model_id="resnet50",
                             consecutive_errors=3, cooldown_s=RES_COOLDOWN_S)
    router = ModelRouter(name="resilience")
    model = ServingModel(net, "resnet50",
                         bucketing=BucketingPolicy(batch_buckets=BUCKETS))
    sched = router.register(model, max_wait_ms=5.0, queue_limit=64,
                            breaker=breaker)
    inj = fl.get_injector()
    inj.clear()
    slo.reset()
    tele = tm.get_telemetry()
    t0 = time.perf_counter()
    server = ModelServer(router, port=0).start()
    warm_s = time.perf_counter() - t0
    base = server.url
    url = f"{base}/v1/models/resnet50/infer"
    rng = np.random.default_rng(2024)
    answers, steps, checked = [], {}, {}
    current = [net]

    def infer(rows, lane="interactive", rid=None, **extra):
        x = quarter_grid(np, rng, rows)
        st, body, hdrs = _http(url, "POST", {"inputs": x.tolist(),
                                             "lane": lane, **extra},
                               {"X-Request-Id": rid} if rid else None)
        if st == 200:
            answers.append((x, np.asarray(body["outputs"], np.float64),
                            current[0]))
        return st, body, hdrs

    def expect(step, got, want):
        steps[step] = got
        if got != want:
            raise AssertionError(f"{step}: {got}, expected {want}")

    kern.reset_counts()
    chunks0 = model.chunks_executed
    reload_launches = {}
    ctrl = None
    try:
        with check_every_launch(torch, checked):
            # request ids: echoed, and the flight recorder holds the record
            st, body, hdrs = infer(2, rid="smoke-rid-1")
            rec = _http(f"{base}/v1/models/resnet50/debug/requests"
                        "?last=4")[1]["requests"]
            expect("request_id", {
                "status": st, "echo": hdrs.get("X-Request-Id"),
                "body_id": body.get("request_id"),
                "recorded": [r["status"] for r in rec
                             if r["id"] == "smoke-rid-1"]},
                {"status": 200, "echo": "smoke-rid-1",
                 "body_id": "smoke-rid-1", "recorded": ["ok"]})
            # an SLO on this model and the brownout hung off it
            slo.register(slo.SloObjective(
                "resnet50-availability", "availability", target=0.999,
                model="resnet50", windows=(600.0,)))
            ctrl = BrownoutController(router).install()
            slo.get_engine().evaluate()  # the baseline sample
            # breaker: three failed batches open it; a probe closes it
            inj.inject(fl.SERVING_COMPUTE_ERROR, count=3)
            errors = [infer(1)[0] for _ in range(3)]
            st, body, hdrs = infer(1)
            opened = {"errors": errors, "open_status": st,
                      "open_error": body.get("error"),
                      "retry_after": hdrs.get("Retry-After"),
                      "state": breaker.state}
            clock[0] += RES_COOLDOWN_S + 0.1
            probe = infer(2)[0]
            expect("breaker", {**opened, "probe": probe,
                               "closed": breaker.state,
                               "opens": breaker.opens,
                               "closes": breaker.closes},
                   {"errors": [500, 500, 500], "open_status": 503,
                    "open_error": "CircuitOpenError",
                    "retry_after": str(int(RES_COOLDOWN_S)),
                    "state": "open", "probe": 200, "closed": "closed",
                    "opens": 1, "closes": 1})
            # worker crash: a loud 500, the loop restarts, serves again
            inj.inject(fl.SERVING_WORKER_CRASH)
            crash = infer(1)
            after = infer(3)[0]
            stats = sched.stats()
            expect("worker_crash", {
                "status": crash[0], "after": after,
                "restarts": stats["worker_restarts"],
                "alive": stats["worker_alive"],
                "recompiles": stats["recompiles"]},
                {"status": 500, "after": 200, "restarts": 1, "alive": True,
                 "recompiles": 0})
            steps["worker_crash"]["error"] = crash[1].get("error", "")[:120]
            # slow batch: requests queued behind it past their deadline
            inj.inject(fl.SERVING_SLOW_BATCH, arg=RES_SLOW_MS)
            with ThreadPoolExecutor(3) as pool:
                stalled = pool.submit(infer, 1)
                _wait(lambda: sched._current_batch is not None, 30,
                      "the stalled batch to open")
                doomed = [pool.submit(infer, 1,
                                      deadline_ms=RES_DEADLINE_MS)
                          for _ in range(2)]
                slow = {"stalled": stalled.result()[0],
                        "doomed": sorted(f.result()[0] for f in doomed)}
            expect("slow_batch", slow, {"stalled": 200,
                                        "doomed": [429, 429]})
            # brownout: the budget is spent, the batch lane sheds
            doc = slo.get_engine().evaluate()
            hz = _http(f"{base}/healthz")[0]
            batch_lane = infer(1, lane="batch")
            interactive = infer(1, lane="interactive")[0]
            slo.reset()  # ends the breach, and the brownout with it
            restored = infer(1, lane="batch")[0]
            expect("brownout", {
                "exhausted": doc["objectives"][0]["exhausted"],
                "healthz_while_exhausted": hz, "batch": batch_lane[0],
                "batch_error": batch_lane[1].get("error"),
                "interactive": interactive, "after_reset": restored,
                "active": ctrl.active},
                {"exhausted": True, "healthz_while_exhausted": 503,
                 "batch": 429, "batch_error": "BrownoutShedError",
                 "interactive": 200, "after_reset": 200, "active": False})
            steps["brownout"]["burn_rate"] = \
                doc["objectives"][0]["windows"]["600s"]["burn_rate"]
            ctrl.uninstall()
            # watch: a republished archive with new weights is followed
            router.watch("resnet50", live, interval_s=0.2)
            tmp = live + ".next"
            snap = kern.snapshot_counts()
            t1 = time.perf_counter()
            ModelSerializer.write_model(net2, tmp, save_updater=False)
            os.replace(tmp, live)
            _wait(lambda: model.version == 2, 300, "the watched reload")
            watch_s = time.perf_counter() - t1
            reload_launches = kern.counts_since(snap)[0]
            current[0] = net2
            followed = infer(2)[0]
            rejected0 = tele.counter_total("serving.reload_rejected_total",
                                           model="resnet50")
            data = open(live, "rb").read()
            with open(tmp, "wb") as f:
                f.write(data[: len(data) // 2])
            os.replace(tmp, live)
            _wait(lambda: tele.counter_total(
                "serving.reload_rejected_total", model="resnet50")
                > rejected0, 120, "the truncated publish's rejection")
            kept = infer(1)[0]
            router.unwatch("resnet50")
            expect("watch", {"version": model.version, "followed": followed,
                             "after_truncated": kept},
                   {"version": 2, "followed": 200, "after_truncated": 200})
            steps["watch"]["reload_s"] = watch_s
            # metrics and health
            st_m, text, _ = _http(f"{base}/metrics")
            families = ("serving_requests_total", "serving_completed_total",
                        "serving_shed_total", "serving_request_errors_total",
                        "serving_breaker_opens_total",
                        "serving_breaker_state", "serving_model_version",
                        "serving_worker_restarts_total",
                        "serving_request_latency_seconds_bucket",
                        "serving_reloads_total",
                        "serving_reload_rejected_total",
                        "serving_queue_depth", "serving_flight_recorder")
            st_h, health, _ = _http(f"{base}/healthz")
            st_s, slo_doc, _ = _http(f"{base}/slo")
            expect("metrics", {
                "status": [st_m, st_h, st_s],
                "missing": [f for f in families if f not in text],
                "serving_section": "serving" in health,
                "slo": slo_doc}, {
                "status": [200, 200, 200], "missing": [],
                "serving_section": True, "slo": {"objectives": []}})
            # drain: queued requests finish, new ones get 503
            inj.inject(fl.SERVING_SLOW_BATCH, arg=RES_SLOW_MS)
            with ThreadPoolExecutor(3) as pool:
                queued = [pool.submit(infer, 1)]
                _wait(lambda: sched._current_batch is not None, 30,
                      "the stalled batch to open")
                queued += [pool.submit(infer, 1) for _ in range(2)]
                _wait(lambda: sched.queue_depth() >= 2, 30,
                      "two requests queued behind it")
                drain = _http(f"{base}/admin/drain", "POST", {})
                late = infer(1)
                done = sorted(f.result()[0] for f in queued)
            drained = server.wait_drained(timeout=60)
            status = _http(f"{base}/admin/status")[1]
            expect("drain", {"drain": drain[0], "queued": done,
                             "late": late[0],
                             "late_retry_after": late[2].get("Retry-After"),
                             "drained": drained,
                             "status_draining": status["draining"]},
                   {"drain": 200, "queued": [200, 200, 200], "late": 503,
                    "late_retry_after": "10", "drained": True,
                    "status_draining": True})
        launches = dict(kern.LAUNCHES)
        plain = dict(kern.PLAIN_ON_CUDA)
    finally:
        inj.clear()
        if ctrl is not None:
            ctrl.uninstall()
        slo.reset()
        server.stop()
        tm.set_health("serving.accepting", True, "phase over")
    chunks = model.chunks_executed - chunks0
    path_launches = launches["conv2d_fwd"] - reload_launches.get(
        "conv2d_fwd", 0)
    if path_launches != 53 * chunks or chunks < 1:
        raise AssertionError(f"{path_launches} K1 launches on the serving "
                             f"path for {chunks} chunks, expected 53 each")
    if any(plain.values()):
        raise AssertionError(f"plain path on CUDA tensors: {plain}")
    if checked.get(("conv2d_fwd", "fp32"), {}).get("calls") \
            != launches["conv2d_fwd"]:
        raise AssertionError(f"{launches['conv2d_fwd']} launches, "
                             f"{_checked_summary(checked)} checked")
    worst, n_answers = served_errors(np, answers)
    emit("serving_resilience", model="ResNet50", input=[224, 224, 3],
         buckets=list(BUCKETS), warmup_s=warm_s, steps=steps,
         answers_200=n_answers, max_abs_err_vs_exact=worst,
         chunks=chunks, conv_launches_path=path_launches,
         conv_launches_watch_reload=reload_launches.get("conv2d_fwd", 0),
         plain_on_cuda=plain["conv2d_fwd"],
         launches_checked=_checked_summary(checked),
         flight_recorder_depth=len(sched.flight),
         phase_s=time.perf_counter() - t_phase, card=card)
    return path_launches, checked


def serving_resilience_captured_leg(torch, np, card):
    """Leg serving_resilience_captured of phase 22j: the worker crash with
    the compiled step on. The scheduler's restarted loop runs on the same
    thread and replays the programs warmup captured (53 K1 launches a
    chunk under replay): nothing is captured again."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (ModelRouter, ServingModel,
                                                  WorkerCrashedError)
    from deeplearning4j_tpu_torch.util import faults as fl
    from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    model = ServingModel(net, "resnet50_captured",
                         bucketing=BucketingPolicy(batch_buckets=BUCKETS))
    router = ModelRouter(name="resilience-captured")
    sched = router.register(model, max_wait_ms=5.0)
    watcher = get_watcher()
    t0 = time.perf_counter()
    with watcher.scope() as warm:
        router.warmup()
    warm_s, warm_programs = time.perf_counter() - t0, warm.traces
    inj = fl.get_injector()
    rng = np.random.default_rng(7)
    answers = []
    try:
        kern.reset_counts()
        chunks0 = model.chunks_executed
        with watcher.scope() as steady:
            x = quarter_grid(np, rng, 3)
            answers.append((x, np.asarray(router.submit(
                "resnet50_captured", x).result(timeout=300), np.float64),
                net))
            inj.inject(fl.SERVING_WORKER_CRASH)
            try:
                router.submit("resnet50_captured",
                              quarter_grid(np, rng, 2)).result(timeout=300)
                raise AssertionError("the crashed batch answered")
            except WorkerCrashedError:
                pass
            for rows in (2, 5):
                x = quarter_grid(np, rng, rows)
                answers.append((x, np.asarray(router.submit(
                    "resnet50_captured", x).result(timeout=300),
                    np.float64), net))
        steady_programs = steady.traces
        stats = sched.stats()
        launches = kern.LAUNCHES["conv2d_fwd"]
        plain = kern.PLAIN_ON_CUDA["conv2d_fwd"]
        chunks = model.chunks_executed - chunks0
    finally:
        inj.clear()
        router.shutdown()
    if stats["worker_restarts"] != 1 or stats["recompiles"] \
            or steady_programs:
        raise AssertionError(f"after the crash: {stats['worker_restarts']} "
                             f"restarts, {stats['recompiles']} programs "
                             f"built by batches, {steady_programs} in all")
    if launches != 53 * chunks or plain:
        raise AssertionError(f"{launches} K1 launches under replay for "
                             f"{chunks} chunks, {plain} plain")
    worst, n = served_errors(np, answers)
    emit("serving_resilience_captured", model="ResNet50",
         warmup_s=warm_s, warmup_programs=warm_programs,
         programs_after_warmup=steady_programs,
         recompiles=stats["recompiles"],
         worker_restarts=stats["worker_restarts"], answers_200=n,
         max_abs_err_vs_exact=worst, chunks=chunks,
         conv_launches_replayed=launches, card=card)
    return launches


# -------------------------------------------------------------- fleet (22k)

FLEET_DIR = os.path.join(ROOT, "build", "smoke_fleet")
FLEET_WORKERS = 2
#: 16 classify requests of 1-16 rows, four at a time
FLEET_ROWS = (1, 4, 16, 2, 8, 3, 12, 5, 1, 16, 6, 2, 9, 4, 7, 11)
FLEET_GEN_BUCKETS = (1, 2, 4, 8)
FLEET_GEN_SEQ = (64, 128)       # max_length (512) is the implicit last
FLEET_POOL_BLOCKS = 256         # per worker, pinned: 4,096 token slots
FLEET_HEAD = 32                 # two shared 32-token heads
FLEET_PROMPT = 64
FLEET_STREAMS = 16
FLEET_NEW = 32
FLEET_AFFINITY_HEAD = 16
#: the fleet's rates: closed-loop clients, four for each worker the
#: requests reach; each rate the median of FLEET_RATE_WINDOWS windows of
#: FLEET_RATE_WINDOW_S
FLEET_RATE_ROWS, FLEET_RATE_CLIENTS_A_WORKER = 8, 4
FLEET_RATE_WINDOWS, FLEET_RATE_WINDOW_S = 3, 2.5
FLEET_KILL_REQUESTS = 8


def _fleet_rate(np, fleet, model, targets, units, tag, check, workers):
    """A closed-loop rate over HTTP: FLEET_RATE_CLIENTS_A_WORKER clients
    for each of the ``workers`` the requests reach, the c-th
    posting ``targets[(c + k * clients) % len(targets)]`` (url, encoded
    body) as its k-th request until the window closes; FLEET_RATE_WINDOWS
    windows of FLEET_RATE_WINDOW_S, each rate the ``units`` a request of
    its requests over the wall until its last answer (median, min, max).
    Every answer is 200; ``check(target index, body)`` gives a number for
    each (an error, or 1 for an answer unlike a reference), reported as
    ``check_max`` and ``check_sum``. Each request carries an ``X-Request-Id``,
    so the workers' flight records split its client wall into the worker
    scheduler's queue, fill and compute and the rest (HTTP, JSON,
    routing): medians over the requests the records still hold."""
    n = FLEET_RATE_CLIENTS_A_WORKER * workers
    rates, walls, checks = [], {}, []
    for win in range(FLEET_RATE_WINDOWS):
        t0 = time.perf_counter()
        deadline = t0 + FLEET_RATE_WINDOW_S

        def client(c):
            done, k = [], 0
            while time.perf_counter() < deadline:
                i = (c + k * n) % len(targets)
                rid = f"{tag}-{win}-{c}-{k}"
                t = time.perf_counter()
                st, body, _ = _http(targets[i][0], "POST", targets[i][1],
                                    {"X-Request-Id": rid})
                done.append((rid, time.perf_counter() - t, st, i, body))
                k += 1
            return done

        with ThreadPoolExecutor(n) as pool:
            done = [d for ds in pool.map(client, range(n)) for d in ds]
        wall = time.perf_counter() - t0
        bad = [st for _, _, st, _, _ in done if st != 200]
        if bad:
            raise AssertionError(f"{tag}: {len(bad)} answers not 200: "
                                 f"{sorted(set(bad))}")
        checks += [check(i, body) for _, _, _, i, body in done]
        rates.append(units * len(done) / wall)
        walls.update((rid, secs) for rid, secs, _, _, _ in done)
    recs = [r for r in fleet.debug_requests(model, last=256)
            if r["id"] in walls]
    by_worker = collections.Counter(r["worker"] for r in recs)

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    rates_sorted = sorted(rates)
    return {
        "median": rates_sorted[len(rates) // 2], "min": rates_sorted[0],
        "max": rates_sorted[-1], "windows": rates,
        "window_s": FLEET_RATE_WINDOW_S, "clients": n,
        "requests": len(walls), "units_a_request": units,
        "check_max": max(checks), "check_sum": sum(checks),
        "client_ms_median": med(1e3 * v for v in walls.values()),
        "traced_requests": len(recs), "traced_by_worker": dict(by_worker),
        **{f"worker_{k}_median": med(r[k] for r in recs
                                     if r.get(k) is not None)
           for k in ("queue_ms", "fill_ms", "compute_ms", "total_ms")},
        "outside_worker_scheduler_ms_median": med(
            1e3 * walls[r["id"]] - r["total_ms"] for r in recs)}


def _worker_conv_counts(fleet):
    """{worker id: [K1 launches, K1 calls on CUDA that took the plain
    path, ResNet-50 chunks executed]}, each read from the worker's own
    ``/v1/models`` (its process's counts)."""
    out = {}
    for w in fleet.workers:
        st, body, _ = _http(f"{w.url}/v1/models")
        if st != 200:
            raise AssertionError(f"{w.worker_id} /v1/models answered {st}")
        k = body["kernels"]
        out[w.worker_id] = [k["launches"]["conv2d_fwd"],
                            k["plain_on_cuda"]["conv2d_fwd"],
                            body["models"]["resnet50"]["chunks_executed"]]
    return out


def fleet_phase(torch, np, card):
    """Phase 22k: a FleetRouter over two worker processes on the card
    (module doc)."""
    import shutil
    import signal

    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import Generator
    from deeplearning4j_tpu_torch.serving.fleet import (FleetRouter,
                                                        affinity_key,
                                                        fleet_spec,
                                                        rendezvous_pick)
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import Bert
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)
    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    net2 = ResNet50(seed=RELOAD_SEED).init(device="cuda")
    _calm_residual_branches(net2)
    lm = Bert.base(causal=True, task="mlm", max_length=GEN_MAXLEN,
                   hidden_dropout=0.0, seed=GEN_SEED).init(device="cuda")
    paths = {k: os.path.join(FLEET_DIR, f"{k}.zip")
             for k in ("resnet50", "resnet50_seed7", "lm")}
    t0 = time.perf_counter()
    for k, n in (("resnet50", net), ("resnet50_seed7", net2), ("lm", lm)):
        ModelSerializer.write_model(n, paths[k], save_updater=False)
    archive_s = time.perf_counter() - t0
    spec = fleet_spec(models=[
        {"id": "resnet50", "path": paths["resnet50"], "kind": "classify",
         "register": {"max_wait_ms": 5.0, "queue_limit": 64},
         "model_kw": {"bucketing": {"batch_buckets": list(BUCKETS)}}},
        {"id": "lm", "path": paths["lm"], "kind": "generate",
         "register": {"max_wait_ms": 5.0, "queue_limit": 64},
         "model_kw": {"bucketing": {"batch_buckets": list(FLEET_GEN_BUCKETS),
                                    "seq_buckets": list(FLEET_GEN_SEQ)},
                      "block_size": GEN_BLOCK,
                      "pool_blocks": FLEET_POOL_BLOCKS,
                      "prefix_cache": True, "max_length": GEN_MAXLEN}}],
        env={"DL4J_TORCH_KERNEL_IMPL": "cuda"})
    rng = np.random.default_rng(4242)
    xs = [quarter_grid(np, rng, r) for r in FLEET_ROWS]
    heads = gen_prompts(np, [FLEET_HEAD] * 2, 300)
    tails = gen_prompts(np, [FLEET_PROMPT - FLEET_HEAD] * FLEET_STREAMS, 301)
    prompts = [heads[i % 2] + tails[i] for i in range(FLEET_STREAMS)]
    # the in-process oracles: every K1 launch checked, eager
    oracle_checked = {}
    kern.reset_counts()
    with capture.disabled(), check_every_launch(torch, oracle_checked):
        want = [net.output(x).double().cpu().numpy() for x in xs]
    oracle_launches = kern.LAUNCHES["conv2d_fwd"]
    oracle_gen = Generator(lm, paged=False, batch_buckets=FLEET_GEN_BUCKETS,
                           prefill_buckets=FLEET_GEN_SEQ,
                           max_length=GEN_MAXLEN)
    oracle_logits = []
    want_tokens = oracle_gen.generate_full_recompute(
        prompts, FLEET_NEW, logits_out=oracle_logits)

    t0 = time.perf_counter()
    fleet = FleetRouter(spec, n_workers=FLEET_WORKERS,
                        affinity_head=FLEET_AFFINITY_HEAD,
                        health_interval_s=0.25, boot_timeout_s=600,
                        request_timeout_s=600, name="smoke",
                        fleet_dir=os.path.join(FLEET_DIR, "run")).start()
    boot_s = time.perf_counter() - t0
    ready_s = {w.worker_id: w.healthy_since - w.spawned_at
               for w in fleet.workers}
    front = fleet.url
    out = {"archive_write_s": archive_s, "boot_s": boot_s,
           "worker_ready_s": ready_s}
    try:
        # each worker's own K1 counts from here to the end of the rates
        counts0 = _worker_conv_counts(fleet)
        # classify through the router, four at a time (bodies encoded
        # before the clock starts)
        url = f"{front}/v1/models/resnet50/infer"
        bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in xs]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda b: _http(url, "POST", b), bodies))
        classify_s = time.perf_counter() - t1
        worst = 0.0
        for (st, body, _), w in zip(got, want):
            if st != 200:
                raise AssertionError(f"classify answered {st}: {body}")
            worst = max(worst, float(np.abs(
                np.asarray(body["outputs"], np.float64) - w).max()))
        if worst > SERVE_TOL:
            raise AssertionError(f"fleet classify off by {worst}")
        out["classify"] = {"requests": len(xs), "rows": list(FLEET_ROWS),
                           "max_abs_err_vs_inprocess": worst,
                           "wall_s": classify_s}
        # generate: streams over two shared heads, affinity-routed
        gurl = f"{front}/v1/models/lm/generate"
        ring = sorted(w.worker_id for w in fleet._ring())

        def gen(i):
            return _http(gurl, "POST", {"prompt_tokens": prompts[i],
                                        "max_new_tokens": FLEET_NEW},
                         {"X-Request-Id": f"smoke-gen-{i}"})

        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            gen_out = list(pool.map(gen, range(FLEET_STREAMS)))
        gen_s = time.perf_counter() - t1
        if any(st != 200 for st, _, _ in gen_out):
            raise AssertionError(f"generate answered "
                                 f"{[st for st, _, _ in gen_out]}")
        tokens = [body["tokens"][0] for _, body, _ in gen_out]
        ties = tied_rows(torch, oracle_gen, prompts, tokens, want_tokens,
                         oracle_logits)
        placed = {r["id"]: r["worker"] for r in fleet.debug_requests("lm")}
        owners = [rendezvous_pick(affinity_key("lm", p,
                                               FLEET_AFFINITY_HEAD), ring)
                  for p in prompts]
        landed = [placed.get(f"smoke-gen-{i}")
                  for i in range(FLEET_STREAMS)]
        if landed != owners:
            raise AssertionError(f"streams landed on {landed}, rendezvous "
                                 f"picks {owners}")
        status = fleet.status()
        out["generate"] = {
            "streams": FLEET_STREAMS, "prompt": FLEET_PROMPT,
            "shared_head": FLEET_HEAD, "new_tokens": FLEET_NEW,
            "tie_rule_rows": ties, "wall_s": gen_s,
            "head_owners": sorted(set(owners)),
            "prefix_cache_hit_rate": {
                w: d["models"].get("lm", {}).get("prefix_cache_hit_rate")
                for w, d in status["workers"].items()}}
        # rates, closed-loop: classify rows/s to one worker straight, to
        # two straight, to two through the router,
        # check_max the worst error against the exact path; generate
        # tokens/s through the router over the 16 prompts (their prefixes
        # cached by now), check_sum the answers unlike the first leg's
        rx = quarter_grid(np, rng, FLEET_RATE_ROWS)
        with kern.impl_scope("exact"):
            want_rx = net.output(rx).double().cpu().numpy()
        body = json.dumps({"inputs": rx.tolist()}).encode()

        def rx_err(_, b):
            return float(np.abs(np.asarray(b["outputs"], np.float64)
                                - want_rx).max())

        direct = [(f"{fleet.worker(w).url}/v1/models/resnet50/infer", body)
                  for w in ("w0", "w1")]
        for tag, targets, workers in (
                ("rate_one_worker_direct", direct[:1], 1),
                ("rate_two_workers_direct", direct, 2),
                ("rate_two_workers_router", [(url, body)], 2)):
            out[tag] = _fleet_rate(np, fleet, "resnet50", targets,
                                   FLEET_RATE_ROWS, tag, rx_err, workers)
            if out[tag]["check_max"] > SERVE_TOL:
                raise AssertionError(f"{tag} off by "
                                     f"{out[tag]['check_max']}")
        gbodies = [(gurl, json.dumps({"prompt_tokens": p,
                                      "max_new_tokens": FLEET_NEW}).encode())
                   for p in prompts]
        out["rate_generate_router"] = _fleet_rate(
            np, fleet, "lm", gbodies, FLEET_NEW, "rate_generate",
            lambda i, b: float(b["tokens"][0] != tokens[i]), FLEET_WORKERS)
        # what each worker launched: 53 K1 launches a chunk, none plain
        counts1 = _worker_conv_counts(fleet)
        worker_k1 = {w: dict(zip(("launches", "plain_on_cuda", "chunks"),
                                 (b - a for a, b in zip(counts0[w],
                                                        counts1[w]))))
                     for w in counts0}
        for w, c in worker_k1.items():
            if c["chunks"] < 1 or c["plain_on_cuda"] \
                    or c["launches"] != 53 * c["chunks"]:
                raise AssertionError(f"worker {w}: {c}")
        out["worker_conv2d_fwd"] = worker_k1
        # SIGKILL one worker under traffic: every request answered
        victim = fleet.worker("w0")
        old_pid = victim.pid
        failover0 = status["routing_decisions"].get("failover", 0)
        kx = [quarter_grid(np, rng, 4) for _ in range(FLEET_KILL_REQUESTS)]
        with kern.impl_scope("exact"):
            kwant = [net.output(x).double().cpu().numpy() for x in kx]
        kbodies = [json.dumps({"inputs": x.tolist()}).encode() for x in kx]
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(_http, url, "POST", b) for b in kbodies[:4]]
            # killed with a request of its in flight: that one fails over
            _wait(lambda: victim.inflight > 0, 60, "a request on w0")
            t_kill = time.perf_counter()
            os.kill(old_pid, signal.SIGKILL)
            futs += [pool.submit(_http, url, "POST", b)
                     for b in kbodies[4:]]
            kill_out = [f.result() for f in futs]
        kill_codes = [st for st, _, _ in kill_out]
        kill_err = max(float(np.abs(np.asarray(b["outputs"], np.float64)
                                    - w).max())
                       for (st, b, _), w in zip(kill_out, kwant)
                       if st == 200)
        if kill_codes != [200] * FLEET_KILL_REQUESTS or kill_err > SERVE_TOL:
            raise AssertionError(f"under SIGKILL: {kill_codes}, "
                                 f"err {kill_err}")
        _wait(lambda: len(fleet._ring()) == FLEET_WORKERS
              and victim.pid != old_pid, 600, "the respawned worker")
        respawn_s = time.perf_counter() - t_kill
        status = fleet.status()
        out["sigkill"] = {
            "killed": "w0", "answered_200": kill_codes.count(200),
            "requests": FLEET_KILL_REQUESTS,
            "max_abs_err_vs_exact": kill_err,
            "failovers": status["routing_decisions"].get("failover", 0)
            - failover0,
            "restarts": victim.restarts, "respawn_to_ring_s": respawn_s,
            "respawned_ready_s": victim.healthy_since - victim.spawned_at}
        if victim.restarts < 1:
            raise AssertionError("the killed worker was not respawned")
        # rolling reload to the second ResNet-50 under live traffic
        before = {w: d["models"]["resnet50"]["version"]
                  for w, d in status["workers"].items()}
        stop, codes = threading.Event(), []
        tx = quarter_grid(np, rng, 2)
        tbody = json.dumps({"inputs": tx.tolist()}).encode()

        def traffic():
            while not stop.is_set():
                codes.append(_http(url, "POST", tbody)[0])

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        t1 = time.perf_counter()
        try:
            st, rbody, _ = _http(f"{front}/v1/models/resnet50/reload",
                                 "POST", {"path": paths["resnet50_seed7"]})
        finally:
            reload_s = time.perf_counter() - t1
            stop.set()
            th.join(timeout=600)
        if st != 200 or not codes or set(codes) != {200}:
            raise AssertionError(f"rolling reload: {st} {rbody}; traffic "
                                 f"answered {sorted(set(codes))}")
        versions = rbody["versions"]
        if sorted(versions) != ["w0", "w1"] or any(
                versions[w] <= before[w] for w in versions):
            raise AssertionError(f"versions {before} -> {versions}")
        with kern.impl_scope("exact"):
            want2 = net2.output(tx).double().cpu().numpy()
        after = [np.asarray(_http(url, "POST", tbody)[1]["outputs"],
                            np.float64) for _ in range(4)]
        reload_err = max(float(np.abs(a - want2).max()) for a in after)
        if reload_err > SERVE_TOL:
            raise AssertionError(f"after the reload off by {reload_err}")
        out["rolling_reload"] = {
            "seconds": reload_s, "versions_before": before,
            "versions_after": versions, "traffic_requests": len(codes),
            "non_200": sum(c != 200 for c in codes),
            "max_abs_err_vs_new_net": reload_err}
        # metrics fan in relabelled per worker
        st_m, text, _ = _http(f"{front}/metrics")
        relabelled = {w: bool(re.search(
            r'serving_completed_total\{worker="%s",' % w, text))
            for w in ("w0", "w1")}
        if st_m != 200 or not all(relabelled.values()) \
                or 'serving_fleet_ring_size{fleet="smoke"} 2' not in text:
            raise AssertionError(f"fleet metrics: {st_m} {relabelled}")
        out["metrics"] = {"relabelled": relabelled,
                          "lines": text.count("\n")}
        out["routing_decisions"] = fleet.status()["routing_decisions"]
    finally:
        fleet.stop(kill_timeout_s=120)
    exit_codes = {w.worker_id: w.proc.returncode for w in fleet.workers}
    if set(exit_codes.values()) != {0}:
        raise AssertionError(f"worker exit codes {exit_codes}")
    emit("fleet", workers=FLEET_WORKERS, models={
        "resnet50": {"params": net.num_params(), "input": [224, 224, 3],
                     "buckets": list(BUCKETS)},
        "lm": {"model": "Bert.base(causal=True, task='mlm')",
               "params": lm.num_params(),
               "batch_buckets": list(FLEET_GEN_BUCKETS),
               "prefill_buckets": list(FLEET_GEN_SEQ) + [GEN_MAXLEN],
               "block_size": GEN_BLOCK, "pool_blocks": FLEET_POOL_BLOCKS,
               "prefix_cache": True}},
         kernel_impl="cuda", affinity_head=FLEET_AFFINITY_HEAD,
         oracle_conv_launches=oracle_launches,
         oracle_launches_checked=_checked_summary(oracle_checked), **out,
         exit_codes=exit_codes, phase_s=time.perf_counter() - t_phase,
         card=card)
    return oracle_launches, oracle_checked, out["worker_conv2d_fwd"]


def lstm_entry(cell_records, seq_records, launches, train_checked,
               sample_launches, sample_checked, bodies, card):
    """K4's line of the kernels table: the segment kernel the main paths
    launch, its times at the training segment (B 32, H 256, T 50, IFOG) and
    at the sampling step (B 4, T 1) beside them, the step body's at both,
    the one-step cell kernel's per launch, errors over every lstm_kernel
    case, launches of the char-RNN's fit calls and of sampling, and the
    bodies those launches ran."""
    def rec(b, order="ifog"):
        return next(r for r in seq_records
                    if r["b"] == b and r["order"] == order)

    train, sample = rec(CHAR_BATCH), rec(SAMPLES)
    cell = next(r for r in cell_records
                if r["b"] == CHAR_BATCH and r["order"] == "ifog")

    def worst(tag, field):
        return max(r[tag][field] for r in seq_records + cell_records)

    entry = {
        "name": "lstm_seq_fwd", "route": "cuda", "source": LSTM_SEQ_SOURCE,
        "source_step_body": LSTM_SOURCE, "replaces": LSTM_REPLACES,
        "replaces_ids": ["K4"], "launches": launches,
        "launches_per_fit_call": launches // CHAR_FITS,
        "launches_sample": sample_launches, "bodies": bodies,
        "max_abs_err": worst("fp32", "max_abs_err"),
        "max_err_normalised_fp32": worst("fp32", "max_err_normalised"),
        "max_err_normalised_bf16": worst("bf16", "max_err_normalised")}
    for suffix, r in (("", train["fp32"]), ("_bf16", train["bf16"]),
                      ("_t1", sample["fp32"]), ("_t1_bf16", sample["bf16"])):
        for field in ("ms", "ms_per_step", "ms_step_body", "plain_ms",
                      "bound_ms", "bound_by", "library_ms",
                      "library_ms_per_step", "cudnn_lstm_ms", "body"):
            entry[field + suffix] = r.get(field)
    for suffix, r in (("", cell["fp32"]), ("_bf16", cell["bf16"])):
        for field in ("ms", "ms_one_launch", "plain_ms", "bound_ms",
                      "library_ms"):
            entry[f"cell_{field}{suffix}"] = r.get(field)
    entry.update({
        "train_checked": {f"{k}_{t}": v for (k, t), v in train_checked.items()
                          if k == "lstm_seq_fwd"},
        "sample_checked_fp32": sample_checked[("lstm_seq_fwd", "fp32")],
        "sample_checked_bf16": sample_checked[("lstm_seq_fwd", "bf16")],
        "per": f"one segment launch at B {CHAR_BATCH}, H {CHAR_UNITS}, T "
               f"{CHAR_TBPTT}, IFOG, fp32 unless suffixed (_bf16; _t1: the "
               f"sampling step, B {SAMPLES}, T 1); ms: 10 launches in one "
               "CUDA graph, per launch; ms_step_body: the step body forced "
               "on the same inputs; library_ms: torch.addmm + "
               "torch._thnn_fused_lstm_cell over the T steps in one CUDA "
               "graph (a yardstick the port never calls); cudnn_lstm_ms: "
               "nn.LSTM over the same T steps (input projection included); "
               "cell_*: the one-step cell kernel per launch at B "
               f"{CHAR_BATCH} (50 launches in one CUDA graph); launches "
               f"from the char_rnn_train phase's {CHAR_FITS} fit calls and "
               "launches_sample from char_rnn_sample (the fp32 net; the "
               "bf16 net's as many, in sample_checked_bf16); bodies: the fit "
               "calls' launches by body; *_checked: every launch of those "
               "paths against the plain version",
        "card": card})
    return entry


def flash_entry(records, launches, serve_checked, masked_launches,
                masked_checked, train_launches, train_checked, bwd_records,
                card):
    """K5's line of the kernels table: times of one launch at the main
    path's geometry (ATTENTION_CASES[0]: batch 8, S=512, 12 heads of 64, no
    mask), errors over every attention_kernel case, launches of the served
    requests, of the masked forwards and of BERT-base's training (with
    their checks), and the FlashAttention backward's worst gradient errors
    and its times per step."""
    main = records[0]

    def worst(tag, field):
        return max(r[tag][field] for r in records)

    flash = "flash_attention_fwd"
    return {
        "name": flash, "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "replaces_ids": ["K5"],
        "launches": launches,
        "launches_masked_forward_fp32": masked_launches["fp32"],
        "launches_masked_forward_bf16": masked_launches["bf16"],
        "max_abs_err": worst("fp32", "max_abs_err"),
        "max_err_normalised_fp32": worst("fp32", "max_err_normalised"),
        "max_err_normalised_bf16": worst("bf16", "max_err_normalised"),
        "max_lse_err": max(worst("fp32", "max_lse_err"),
                           worst("bf16", "max_lse_err")),
        "ms": main["fp32"]["ms"], "plain_ms": main["fp32"]["plain_ms"],
        "bound_ms": main["fp32"]["bound_ms"],
        "bound_by": main["fp32"]["bound_by"],
        "library_ms": main["fp32"]["library_ms"],
        "ms_bf16": main["bf16"]["ms"],
        "plain_ms_bf16": main["bf16"]["plain_ms"],
        "bound_ms_bf16": main["bf16"]["bound_ms"],
        "bound_by_bf16": main["bf16"]["bound_by"],
        "library_ms_bf16": main["bf16"]["library_ms"],
        "rows_per_block_bf16": main["bf16"]["rows_per_block"],
        "raw_launch_refuses_inputs_that_require_grad": True,
        "launches_train": train_launches,
        "train_checked_fp32": train_checked[(flash, "fp32")],
        "train_checked_bf16": train_checked[(flash, "bf16")],
        "backward": {
            "source": "deeplearning4j_tpu_torch/ops/kernels/attention.py "
                      "flash_attention_bwd_reference (plain torch)",
            "replaces": "deeplearning4j_tpu/ops/attention.py:268 _flash_bwd "
                        "(jnp, not Pallas)",
            "max_err_fp32": max(max(r["fp32"]["err_dq_dk_dv"])
                                for r in bwd_records),
            "max_err_bf16": max(max(r["bf16"]["err_dq_dk_dv"])
                                for r in bwd_records),
            "per_step": {f"s{r['s']}_{tag}": {
                k: r[tag][k] for k in ("ms", "eager_ms", "ms_per_step",
                                       "sdpa_bwd_ms", "exact_bwd_ms",
                                       "bound_ms", "bound_by")}
                for r in bwd_records if "ms" in r["fp32"]
                for tag in ("fp32", "bf16")}},
        "serve_checked_fp32": serve_checked[(flash, "fp32")],
        "masked_forward_checked_fp32": masked_checked[(flash, "fp32")],
        "masked_forward_checked_bf16": masked_checked[(flash, "bf16")],
        "per": "one launch at batch 8, S=512, 12 heads of 64, no mask, fp32 "
               "unless suffixed _bf16; ms by CUDA graph replay; library_ms "
               "is torch's scaled_dot_product_attention on the same tensors "
               "(a yardstick the port never calls); errors over the "
               f"{len(records)} attention_kernel cases; launches from the "
               f"bert_serve phase ({BERT_LAYERS} per executed chunk), "
               "launches_masked_forward_* from one masked batch-32 forward "
               "in each type, launches_train from bert_train's fit "
               f"({BERT_LAYERS} per step; train_checked_bf16 from its bf16 "
               "step); *_checked: every launch of those paths against the "
               "plain version; backward: the FlashAttention Function's "
               "dq/dk/dv against fp64 over bert_flash_backward's cases, "
               "and its device time per launch (forward and backward in "
               "one CUDA graph less the forward's; eager_ms: the backward "
               "alone from a Python loop) at batch 32, no mask, with "
               "SDPA's and the exact path's backward timed the same way, "
               f"x{BERT_LAYERS} per step",
        "card": card}


def _per_kernel(name, launches):
    """``launches`` (a phase's counts by part) for kernel ``name``: a
    count by kernel read for it, an int (a serve part's K1 launches) for
    K1 only, nested parts part by part."""
    if isinstance(launches, int):
        return launches if name == "conv2d_fwd" else 0
    if launches and all(isinstance(v, dict) for v in launches.values()):
        return {k: _per_kernel(name, v) for k, v in launches.items()}
    return launches.get(name, 0)


def depthwise_phase_fields(prefix, name, launches, checked, records,
                           checked_fields, per):
    """A kernel's fields in the kernels line for a model phase with
    depthwise convs (conv_zoo, keras_import): its launches by part
    (``launches_<prefix>``; 0 for the kernels not on the path), the checks
    of the eager parts (``<prefix>_checked``), and, for K1, dgrad and K3,
    its times at the model's depthwise geometries (batch 8) beside the
    plain version's, cuDNN's and the bound, and their sums over one pass
    by stride (``<prefix>_depthwise*``; ``per`` says what they are)."""
    out = {f"launches_{prefix}": {part: _per_kernel(name, c)
                                  for part, c in launches.items()},
           f"{prefix}_checked": {part: checked_fields(name, c)
                                 for part, c in checked.items()}}
    kname = {"conv2d_fwd": "fwd", "conv2d_dgrad": "dgrad",
             "conv2d_wgrad": "wgrad"}.get(name)
    if kname is None:
        return out
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "body",
              "splits")
    out[f"{prefix}_depthwise"] = {
        f"{r['hw']}x{r['hw']}x{r['c']}_s{r['stride']}": {
            "per_pass": r["per_pass"],
            **{tag: {f: r[f"{kname}_{tag}"].get(f) for f in fields}
               for tag in ("fp32", "bf16")}}
        for r in records}
    for tag in ("fp32", "bf16"):
        for s in sorted({r["stride"] for r in records}):
            out[f"{prefix}_depthwise_pass_s{s}_{tag}"] = {
                f: sum(r[f"{kname}_{tag}"][f] * r["per_pass"]
                       for r in records if r["stride"] == s)
                for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out[f"{prefix}_depthwise_per"] = per
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops.kernels import _build
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         tf32=False)

    t0 = time.perf_counter()
    _build.load()
    log = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=str(_build.build()),
         ptxas=[ln.split("ptxas info    : ", 1)[-1] for ln in log
                if "Compiling entry" in ln or "registers" in ln])

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    # the phases of the earlier slices run eagerly, as they did: their
    # per-launch checks need every launch to go through a wrapper, and
    # their rates are the eager ones the capture phases stand beside
    with capture.disabled():
        conf = ResNet50().conf()
        records = timed("kernel", kernel_phase, torch, conf)
        grad_records = timed("kernel_grad", kernel_grad_phase, torch, conf)
        launches, serve_checked = timed("serve", serve_phase, torch, np, smi)
        train_launches, train_checked, train_bodies16 = timed(
            "train", train_phase, torch, np, smi)
        att_records = timed("attention_kernel", attention_kernel_phase,
                            torch, np)
        timed("attention_sweep", attention_sweep, torch, np, smi)
        bert, bert_launches, bert_checked = timed(
            "bert_serve", bert_serve_phase, torch, np, smi)
        masked_launches, masked_checked = timed(
            "bert_forward", bert_forward_phase, torch, np, smi, bert)
        del bert
        torch.cuda.empty_cache()
        bert_train_launches, bert_train_checked, bwd_records = timed(
            "bert_train", bert_train_phase, torch, np, smi)
        lstm_records, lstm_seq_records = timed(
            "lstm_kernel", lstm_kernel_phase, torch, np)
        (char_net_trained, char_launches, char_checked, char_bodies,
         char_net16, char_rates) = timed(
            "char_rnn_train", char_rnn_train_phase, torch, np, smi)
        sample_launches, sample_checked = timed(
            "char_rnn_sample", char_rnn_sample_phase, torch, np, smi,
            char_net_trained, char_net16)
        del char_net_trained, char_net16
        lenet_launches, lenet_checked, lenet_bodies16 = timed(
            "lenet", lenet_phase, torch, np, smi)
        torch.cuda.empty_cache()
        rec_launches, rec_checked = timed(
            "recurrent_layers", recurrent_layers_phase, torch, np, smi)
        timed("graves_char_rnn", graves_char_rnn_phase, torch, np, smi,
              char_rates)
        seq_launches, seq_checked = timed("seq_graph", seq_graph_phase, torch,
                                          np, smi)
        op_launches, op_checked = timed("op_table", op_table_phase, torch, np,
                                        smi)
        torch.cuda.empty_cache()
        zoo_launches, zoo_checked, dw_records, zoo_proto, zoo_batch = timed(
            "conv_zoo", conv_zoo_phase, torch, np, smi)
    zoo_launches["captured"] = timed(
        "conv_zoo_captured", captured_train_phase, torch, smi, "conv_zoo",
        "Xception", zoo_proto, zoo_batch, XCEPTION_STEP, ZOO_CAPTURE_STEPS)
    del zoo_proto, zoo_batch
    torch.cuda.empty_cache()
    with capture.disabled():
        keras_launches, keras_checked, keras_records, keras_proto, \
            keras_batch = timed("keras_import", keras_import_phase, torch,
                                np, smi)
    keras_launches["captured"] = timed(
        "keras_import_captured", captured_train_phase, torch, smi,
        "keras_import", "MobileNetV2", keras_proto, keras_batch, MNV2_STEP,
        MNV2_STEPS)
    del keras_proto, keras_batch
    torch.cuda.empty_cache()
    capture_launches = {
        "serve": timed("capture_serve", capture_serve_phase, torch, np, smi),
        "train": timed("capture_train", capture_train_phase, torch, np,
                       smi),
        "bert_train": timed("capture_bert_train", capture_bert_train_phase,
                            torch, np, smi),
        "small": timed("capture_small", capture_small_phase, torch, np, smi),
    }
    timed("serialize", serialize_phase, torch, np, smi)
    timed("checkpoint", checkpoint_phase, torch, np, smi)
    torch.cuda.empty_cache()
    sd_bert = timed("samediff_tf_bert", samediff_tf_bert_phase, torch, np,
                    smi)
    timed("samediff_save", samediff_save_phase, torch, np, smi, *sd_bert)
    del sd_bert
    torch.cuda.empty_cache()
    sd_resnet = timed("samediff_tf_resnet", samediff_tf_resnet_phase, torch,
                      np, smi)
    torch.cuda.empty_cache()
    sd_lstm_launches, sd_lstm_checked = timed(
        "samediff_onnx_lstm", samediff_onnx_lstm_phase, torch, np, smi)
    torch.cuda.empty_cache()
    dp_launches, dp_checks = timed("data_pipeline", data_pipeline_phase,
                                   torch, np, smi)
    torch.cuda.empty_cache()
    gen_launches = timed("generate", generate_phase, torch, np, smi)
    torch.cuda.empty_cache()
    with capture.disabled():
        int8_launches, int8_checked = timed("serve_int8", serve_int8_leg,
                                            torch, np, smi)
        torch.cuda.empty_cache()
        res_launches, res_checked = timed(
            "serving_resilience", serving_resilience_phase, torch, np, smi)
    res_captured = timed("serving_resilience_captured",
                         serving_resilience_captured_leg, torch, np, smi)
    torch.cuda.empty_cache()
    fleet_launches, fleet_checked, fleet_workers = timed(
        "fleet", fleet_phase, torch, np, smi)
    emit("timing", seconds=seconds, total_s=time.perf_counter() - t_start,
         capture_phases_s=sum(v for k, v in seconds.items()
                              if k.startswith("capture_")))

    def checked_fields(name, checked):
        """The main path's own launches held against the plain version
        (check_every_launch): their count and worst errors."""
        return {f"checked_{tag}": checked[(name, tag)]
                for tag in ("fp32", "bf16") if (name, tag) in checked}

    per_fwd = [r for r in records if r["launches_per_forward"]]

    def bodies(recs, tag, per):
        """{body: launches per pass} over the path's geometries."""
        out = {}
        for r in recs:
            if r[per]:
                b = r[tag]["body"]
                out[b] = out.get(b, 0) + r[per]
        return out

    def total(tag, field):
        return sum(r[tag][field] * r["launches_per_forward"] for r in per_fwd)

    def lenet_fields(kname, recs, field, per):
        """LeNet's launches of one kernel on its main path (the epoch) and
        the kernel's times at LeNet's geometries, summed over a step."""
        def tot(tag, f):
            return sum(r[field(tag)][f] * r[per] for r in recs
                       if r.get("lenet"))

        out = {"launches": lenet_launches[kname],
               "bf16_bodies": {k.split("/")[1]: v for k, v in
                               lenet_bodies16.items()
                               if k.startswith(f"{kname}/")},
               **checked_fields(kname, lenet_checked),
               "per": f"one LeNet train step at batch {LENET_BATCH} (its "
                      f"{sum(r[per] for r in recs if r.get('lenet'))} "
                      "launches summed), fp32 unless suffixed _bf16; "
                      "launches from the LeNet epoch"}
        for tag, sfx in (("fp32", ""), ("bf16", "_bf16")):
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                out[f + sfx] = tot(tag, f)
        return out

    def convlstm_fields(kname):
        """ConvLSTM2D's launches of one conv kernel in recurrent_layers
        (B 8, T 10, 64x64x1 -> 64 filters; fp32 and bf16, forward and
        backward), every one checked."""
        return {"launches_convlstm": rec_launches[kname],
                **{f"convlstm_{k}": v for k, v in checked_fields(
                    kname, rec_checked).items()}}

    def grad_entry(kname, source, replaces, per_step):
        def tot(tag, field):
            return sum(r[f"{kname}_{tag}"][field] * r[per_step]
                       for r in grad_records)

        ops, byt = tot("fp32", "ops_ms"), tot("fp32", "bytes_ms")
        return {
            "name": f"conv2d_{kname}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[
                f"conv2d_{kname}"],
            "max_abs_err": max(r[f"{kname}_fp32"]["max_abs_err"]
                               for r in grad_records),
            "max_err_normalised_fp32": max(
                r[f"{kname}_fp32"]["max_err_normalised"]
                for r in grad_records),
            "max_err_normalised_bf16": max(
                r[f"{kname}_bf16"]["max_err_normalised"]
                for r in grad_records),
            "ms": tot("fp32", "ms"), "plain_ms": tot("fp32", "plain_ms"),
            "bound_ms": tot("fp32", "bound_ms"),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": tot("fp32", "library_ms"),
            "ms_bf16": tot("bf16", "ms"),
            "plain_ms_bf16": tot("bf16", "plain_ms"),
            "bound_ms_bf16": tot("bf16", "bound_ms"),
            "library_ms_bf16": tot("bf16", "library_ms"),
            "bodies_fp32": bodies(grad_records, f"{kname}_fp32", per_step),
            "bodies_bf16": bodies(grad_records, f"{kname}_bf16", per_step),
            "bodies_bf16_train_step": {
                k.split("/")[1]: v for k, v in train_bodies16.items()
                if k.startswith(f"conv2d_{kname}/")},
            **checked_fields(f"conv2d_{kname}", train_checked),
            "lenet": lenet_fields(f"conv2d_{kname}", grad_records,
                                  lambda tag: f"{kname}_{tag}",
                                  f"lenet_{kname}_per_step"),
            **convlstm_fields(f"conv2d_{kname}"),
            "launches_captured": {
                "train": capture_launches["train"][f"conv2d_{kname}"],
                "lenet": capture_launches["small"]["lenet"][
                    f"conv2d_{kname}"]},
            "per": "one 224x224 ResNet-50 train step at batch 8 (its "
                   f"{sum(r[per_step] for r in grad_records)} launches "
                   "summed), fp32 unless suffixed _bf16; ms by CUDA graph "
                   "replay; launches from the train phase's 4 fit steps at "
                   "batch 32; checked_*: every launch of those steps (fp32) "
                   "and of one bf16 step against the plain version",
            "card": smi}

    entries = [{
        "name": "conv2d_fwd", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES, "replaces_also": CONV_REPLACES_TILED,
        "replaces_ids": ["K1", "K2"], "launches": launches,
        "launches_train": train_launches["conv2d_fwd"],
        "max_abs_err": max(r["fp32"]["max_abs_err"] for r in records),
        "max_err_fp32": max(r["fp32"]["max_abs_err"] for r in records),
        "max_err_bf16": max(r["bf16"]["max_abs_err"] for r in records),
        "ms": total("fp32", "ms"), "eager_ms": total("fp32", "eager_ms"),
        "plain_ms": total("fp32", "plain_ms"),
        "bound_ms": total("fp32", "bound_ms"),
        "bound_by": ("operations" if total("fp32", "ops_ms")
                     >= total("fp32", "bytes_ms") else "bytes"),
        "library_ms": total("fp32", "library_ms"),
        "ms_bf16": total("bf16", "ms"),
        "plain_ms_bf16": total("bf16", "plain_ms"),
        "bodies_fp32": bodies(records, "fp32", "launches_per_forward"),
        "bodies_bf16": bodies(records, "bf16", "launches_per_forward"),
        "bodies_bf16_train_step": {
            k.split("/")[1]: v for k, v in train_bodies16.items()
            if k.startswith("conv2d_fwd/")},
        "eager_ms_bf16": total("bf16", "eager_ms"),
        "bound_ms_bf16": total("bf16", "bound_ms"),
        "library_ms_bf16": total("bf16", "library_ms"),
        **{f"serve_{k}": v for k, v in checked_fields(
            "conv2d_fwd", serve_checked).items()},
        "launches_serve_int8": int8_launches,
        **{f"serve_int8_{k}": v for k, v in checked_fields(
            "conv2d_fwd", int8_checked).items()},
        "launches_serving_resilience": res_launches,
        **{f"serving_resilience_{k}": v for k, v in checked_fields(
            "conv2d_fwd", res_checked).items()},
        "launches_serving_resilience_captured": res_captured,
        "launches_fleet_inprocess": fleet_launches,
        "launches_fleet_workers": fleet_workers,
        **{f"fleet_inprocess_{k}": v for k, v in checked_fields(
            "conv2d_fwd", fleet_checked).items()},
        **{f"train_{k}": v for k, v in checked_fields(
            "conv2d_fwd", train_checked).items()},
        "launches_captured": {
            "serve": capture_launches["serve"],
            "train": capture_launches["train"]["conv2d_fwd"],
            "lenet": capture_launches["small"]["lenet"]["conv2d_fwd"]},
        "lenet": lenet_fields("conv2d_fwd", records, lambda tag: tag,
                              "lenet_per_step"),
        **convlstm_fields("conv2d_fwd"),
        "per": "one 224x224 ResNet-50 forward at batch 8 (its 53 launches "
               "summed), fp32 unless suffixed _bf16; ms by CUDA graph "
               "replay, eager_ms by a Python loop; launches from the serve "
               "phase (53 per executed chunk), launches_serve_int8 from the "
               "int8 ResNet-50 served in serve_int8 (53 per chunk), "
               "launches_serving_resilience from phase 22j's HTTP "
               "requests (53 per chunk, the watched reload's warmup apart), "
               "launches_serving_resilience_captured from its captured "
               "leg (53 per chunk under replay), launches_fleet_inprocess "
               "from phase 22k's in-process oracle, launches_fleet_workers "
               "each fleet worker's own count (its /v1/models) over the "
               "classify and rate legs, with its chunks and plain calls "
               "(53 per chunk, 0 plain), launches_train from the train "
               "phase's 4 "
               "fit steps; serve_/train_checked_*: every launch of those "
               "paths (and of one bf16 fit step) against the plain version",
        "card": smi},
        grad_entry("dgrad", CONV_SOURCE, DGRAD_REPLACES, "dgrad_per_step"),
        grad_entry("wgrad", WGRAD_SOURCE, WGRAD_REPLACES, "wgrad_per_step"),
        {**flash_entry(att_records, bert_launches, bert_checked,
                       masked_launches, masked_checked, bert_train_launches,
                       bert_train_checked, bwd_records, smi),
         "launches_captured": {"bert_train": capture_launches["bert_train"]}},
        {**lstm_entry(lstm_records, lstm_seq_records, char_launches,
                      char_checked, sample_launches, sample_checked,
                      char_bodies, smi),
         "launches_recurrent_layers": rec_launches["lstm_seq_fwd"],
         "recurrent_layers_checked": checked_fields("lstm_seq_fwd",
                                                    rec_checked),
         "launches_seq_graph": seq_launches,
         "launches_captured": {
             k: capture_launches["small"][k]["lstm_seq_fwd"]
             for k in ("char_rnn_tbptt", "seq_graph_last",
                       "seq_graph_pool")},
         "seq_graph_checked": {k: checked_fields("lstm_seq_fwd", c)
                               for k, c in seq_checked.items()}},
    ]
    for e in entries:  # the imported graphs' launches (SameDiff phases)
        name = e["name"]
        if name in SD_RESNET_STEP:
            e["launches_samediff"] = {
                "tf_resnet_forward": sd_resnet["forward"].get(name, 0),
                "tf_resnet_fit": sd_resnet["fit"][name],
                "tf_resnet_captured_step": sd_resnet["captured_step"][name]}
            e.update({f"samediff_forward_{k}": v for k, v in checked_fields(
                name, sd_resnet["forward_checked"]).items()})
            e.update({f"samediff_fit_{k}": v for k, v in checked_fields(
                name, sd_resnet["fit_checked"]).items()})
        elif name == "lstm_seq_fwd":
            e["launches_samediff"] = {f"onnx_lstm_{k}": v
                                      for k, v in sd_lstm_launches.items()}
            e.update({f"samediff_{k}": v for k, v in checked_fields(
                name, sd_lstm_checked).items()})
        else:
            e["launches_samediff"] = {"tf_bert": 0}
    for e in entries:  # the op table's launches by name, every one checked
        e["launches_op_table"] = op_launches.get(e["name"], 0)
        e.update({f"op_table_{k}": v for k, v in checked_fields(
            e["name"], op_checked).items()})
    library = ("library: cuDNN (F.conv2d / torch.nn.grad with groups = "
               "C), a yardstick the port never calls")
    for e in entries:  # the conv zoo's and the Keras import's, every eager
        # one checked
        e.update(depthwise_phase_fields(
            "conv_zoo", e["name"], zoo_launches, zoo_checked, dw_records,
            checked_fields, "one depthwise launch at batch 8 per geometry "
            "(3x3, stride 1, SAME, groups = C); conv_zoo_depthwise_pass_*: "
            f"summed over the 34 of one 299x299 Xception pass; {library}"))
        e.update(depthwise_phase_fields(
            "keras", e["name"], keras_launches, keras_checked, keras_records,
            checked_fields, "one depthwise launch at batch 8 per geometry "
            "(3x3, groups = C; stride 1 SAME, stride 2 VALID on the padded "
            "map); keras_depthwise_pass_s*: summed over the 13 stride-1 and "
            "the 4 stride-2 launches of one 224x224 MobileNetV2 pass; "
            f"{library}"))
    for e in entries:  # the data pipeline's legs, every eager one checked
        e["launches_data_pipeline"] = {
            f"{leg}_{part}": n.get(e["name"], 0)
            for leg, parts in dp_launches.items()
            for part, n in parts.items()}
        e["data_pipeline_checked"] = {
            f"{leg}_{part}": checked_fields(e["name"], c)
            for leg, parts in dp_checks.items() for part, c in parts.items()
            if checked_fields(e["name"], c)}
    for e in entries:  # the decode tier runs no kernel (exact attention)
        e["launches_generate"] = gen_launches
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
