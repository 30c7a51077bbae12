"""Operations and bytes of the training forward (K2, ``csrc/gnn_forward.cu``
with prebuilt edges) on a batch: the forward's matmul FLOPs on the real rows
and ``edges`` real edges; its inputs read once (node rows, tables, weights,
the newest frame), pred and motion written once, and the activations that it
keeps for the backward written once (float32, counted on the real rows and
edges)."""

from work import gnn_step


def work(m, B, edges, slots):
    N, n_p, nf, P = m["n_nodes"], m["max_nobj"], m["nf_effect"], m["pstep"]
    nfp, nfr, rin = m["nf_particle"], m["nf_relation"], m["relation_input_dim"]
    Np = (N + 7) // 8 * 8
    acts = (B * N * (2 * nfp + (P + 1) * nf + 3 * nf + P * nf + 2 * nf)
            + edges * (rin + 2 * nfr + 2 * nf + P * nf))
    nbytes = (gnn_step.table_bytes(m, B, slots) + B * Np * 3 * 4 + 2 * B * n_p * 3 * 4
              + acts * 4)
    return gnn_step.forward_ops(m, B, edges), nbytes
