"""The op table of the port and its families (counterpart of
deeplearning4j_tpu/ops): importing this package registers every op, in
the reference's order, so a name registered twice resolves to the same
family as there (``dot_product_attention``: ``ops/nn.py``'s).

    from deeplearning4j_tpu_torch import ops
    ops.exec_op("conv2d", x, w)      # by name (OpExecutioner parity)
    ops.nn.conv2d(x, w)              # the same function
"""

from deeplearning4j_tpu_torch.ops.registry import (  # noqa: F401
    OpDef, OpNotFoundError, ShapeDtype, add_alias, aliases, categories,
    exec_op, get_op, has_op, list_ops, op, op_count, register, shape_of)

# Importing the family modules registers their ops.
from deeplearning4j_tpu_torch.ops import (  # noqa: F401,E402
    attention, compression, elementwise, image, linalg, nlp_ops, nn, random,
    reduce, rnn, shape_ops, signal, updater_ops)

# Reference spellings for ops registered under their canonical names here
add_alias("sigm_cross_entropy_loss", "sigmoid_cross_entropy")
add_alias("softmax_cross_entropy_loss_with_logits", "softmax_cross_entropy")
add_alias("sparse_softmax_cross_entropy_loss_with_logits",
          "sparse_softmax_cross_entropy")
add_alias("lrelu", "leakyrelu")
