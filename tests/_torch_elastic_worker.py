"""One member of a supervised elastic run of the port, as its own OS
process (the port's counterpart of the reference's ``_dist_worker.py``
elastic modes):

    python _torch_elastic_worker.py <mode> <shared_dir> <process_id> <world>
        [sigkill_at] [device] [eager]

``mode``: ``plain`` (a MultiLayerNetwork's own step), ``compress`` (a
compressed ``ParallelWrapper`` of 4 lanes), ``pipe`` (a
``PipelinedTrainer`` of 2 stages over 2 lanes), or ``conf`` (a
one-lane ``PipelinedTrainer`` over the network that
``<shared_dir>/net.json`` configures, initialised from its seed, on the
batches of ``<shared_dir>/data.npz``: ``x``, ``y`` and ``batch``; no
initial checkpoint, one at every epoch end). Each member trains its own
replica on its share of the batches (batch ``i`` belongs to
``i % world == rank``), as the reference's members do without a
collective; ``sigkill_at`` (``-`` for none) arms the ``sigkill_host``
fault at that step. ``device`` defaults to ``cpu``; ``eager`` runs every
step outside capture. The last line of the output is a JSON summary.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def build_net(mode, device, shared_dir):
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    if mode == "conf":
        with open(os.path.join(shared_dir, "net.json")) as f:
            conf = MultiLayerConfiguration.from_json(f.read())
        return MultiLayerNetwork(conf).init(device=device)
    b = NeuralNetConfiguration.builder().seed(7)
    if mode == "pipe":
        lb = (b.updater({"@updater": "Adam", "learning_rate": 1e-2})
              .pipe_stages(2).n_micro(2).list()
              .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
              .stage_boundary()
              .layer(DenseLayer(n_in=16, n_out=16, activation="tanh"))
              .stage_boundary()
              .layer(DenseLayer(n_in=16, n_out=16, activation="tanh"))
              .stage_boundary())
    else:
        b = b.updater({"@updater": "Sgd", "learning_rate": 0.05})
        if mode == "compress":
            b = b.grad_compression("threshold", threshold=1e-3)
        lb = b.list().layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
    conf = (lb.layer(OutputLayer(n_in=16, n_out=4, loss="mcxent",
                                 activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf).init(device=device)


def build_trainer(mode, net):
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   PipelinedTrainer)

    if mode == "compress":
        return ParallelWrapper(net, replicas=4, skew_every=0)
    if mode == "pipe":
        return PipelinedTrainer(net, replicas=2, skew_every=0)
    if mode == "conf":
        return PipelinedTrainer(net, skew_every=0)
    return net


def main():
    mode, shared_dir = sys.argv[1], sys.argv[2]
    pid, world = int(sys.argv[3]), int(sys.argv[4])
    sigkill_at = int(sys.argv[5]) if len(sys.argv) > 5 and \
        sys.argv[5] != "-" else None
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    eager = len(sys.argv) > 7 and sys.argv[7] == "eager"
    import contextlib

    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.parallel import (ElasticTrainer,
                                                   FileMembership)
    from deeplearning4j_tpu_torch.tree import tree_leaves
    from deeplearning4j_tpu_torch.util.faults import (SIGKILL_HOST,
                                                      get_injector)

    net = build_net(mode, device, shared_dir)
    model = build_trainer(mode, net)
    if mode == "conf":
        data = np.load(os.path.join(shared_dir, "data.npz"))
        it = ArrayDataSetIterator(data["x"], data["y"],
                                  batch=int(data["batch"]))
    else:
        rng = np.random.default_rng(0)  # the same data on every member
        xs = rng.standard_normal((64, 8)).astype(np.float32)
        ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
        it = ArrayDataSetIterator(xs, ys, batch=8)  # 8 batches an epoch
    if sigkill_at is not None:
        get_injector().inject(SIGKILL_HOST, at_step=sigkill_at)
    membership = FileMembership(
        os.path.join(shared_dir, "membership"), process_id=pid,
        world_size=world, heartbeat_interval=0.3, miss_threshold=8,
        barrier_timeout=90.0, log_fn=None)
    kern.reset_counts()
    trainer = ElasticTrainer(
        model, os.path.join(shared_dir, f"ckpt-{pid}"),
        checkpoint_every=1000 if mode == "conf" else 4,
        initial_checkpoint=mode != "conf", membership=membership,
        log_fn=None)
    with capture.disabled() if eager else contextlib.nullcontext():
        trainer.fit(it, epochs=3)
    # the final checkpoint restores what the run holds, bit for bit
    net2 = build_net(mode, device, shared_dir)
    trainer.ckpt.restore(net2)
    exact = all(bool((a == b).all()) for a, b in zip(
        tree_leaves([net.params, net.opt_states]),
        tree_leaves([net2.params, net2.opt_states])))
    extra = {}
    if mode == "compress":
        live = tree_leaves(net._grad_comp_state)
        back = tree_leaves(net2._grad_comp_state)
        extra["residual_exact"] = bool(
            len(live) == len(back)
            and all(bool((np.asarray(a.cpu()) == np.asarray(b)).all())
                    for a, b in zip(live, back))
            and any(bool(a.abs().max() > 0) for a in live))
        st = model.compression_stats()
        extra["wire_bytes"] = st["wire_bytes"] if st else None
        extra["threshold"] = st["threshold"] if st else None
    if mode in ("pipe", "conf"):
        pt2 = build_trainer(mode, net2)
        pt2._build()
        model.sync_model()
        extra["stacked_exact"] = all(bool((a == b).all()) for a, b in zip(
            tree_leaves([model._pp["params"], model._pp["opts"]]),
            tree_leaves([pt2._pp["params"], pt2._pp["opts"]])))
        extra["pipe_stages"] = model.pipe_stages
        extra["bubble_fraction"] = model.bubble_fraction
    view = membership.view
    print(json.dumps({
        "pid": pid, "mode": mode, "device": device,
        "state": trainer.state,
        "iteration": net.iteration,
        "epoch": net.epoch,
        "world_final": view.world if view else None,
        "members_final": list(view.members) if view else None,
        "regroups": membership.regroups,
        "score_finite": bool(np.isfinite(float(net.score_value))),
        "checkpoint_exact": exact,
        "launches": {k: v for k, v in kern.LAUNCHES.items() if v},
        "plain_on_cuda": {k: v for k, v in kern.PLAIN_ON_CUDA.items() if v},
        **extra,
    }), flush=True)


if __name__ == "__main__":
    main()
