"""Operations and bytes of the training backward (K3,
``csrc/gnn_train_bwd.cu``) as a function of its own inputs: two products a
layer (dX = dY W^T and dW = X^T dY) over the forward's FLOPs on the real
rows and ``edges`` real edges; each input read once (node rows, tables,
weights, the gradient of the motion) and each output written once (the node
rows' gradient and the float32 weight gradients). The activations that the
present design reads back from the forward are its choice, not the
function's, and are not counted."""

from work import gnn_step


def work(m, B, edges, slots):
    N = m["n_nodes"]
    Np = (N + 7) // 8 * 8
    D = m["particle_input_dim"] + m["n_his"] * 3 + 3
    nbytes = (gnn_step.table_bytes(m, B, slots) + B * Np * 3 * 4
              + B * Np * D * 4 + gnn_step.n_weights(m) * 4)
    return 2 * gnn_step.forward_ops(m, B, edges), nbytes
