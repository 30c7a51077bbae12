"""Operations and bytes of one GNN step on a prebuilt graph (the forward
that training runs, K2, and its backward, K3) on the N real rows of each
sample and ``edges`` real edges in all: the matmul FLOPs of the forward, and
its node-table, weight and output sizes."""


def n_weights(m):
    nfp, nfr, nf, rin, Dp = (m["nf_particle"], m["nf_relation"], m["nf_effect"],
                             m["relation_input_dim"], m["particle_input_dim"])
    return (Dp * nfp + nfp + nfp * nfp + nfp + nfp * nf + nf
            + rin * nfr + nfr + nfr * nfr + nfr + nfr * nf + nf
            + 3 * nf * nf + nf + 2 * nf * nf + nf + nf * nf + nf + nf * nf + nf + nf * 3 + 3)


def forward_ops(m, B, edges):
    N, n_p, nf, P = m["n_nodes"], m["max_nobj"], m["nf_effect"], m["pstep"]
    nfp, nfr, rin, Dp = (m["nf_particle"], m["nf_relation"], m["relation_input_dim"],
                         m["particle_input_dim"])
    node = Dp * nfp + nfp * nfp + nfp * nf + nf * nf + P * (nf * 2 * nf + nf * nf)
    head = 2 * nf * nf + nf * 3  # the motion head runs on the object rows
    edge = rin * nfr + nfr * nfr + nfr * nf + nf * nf
    return 2 * (B * N * node + B * n_p * head + edges * edge)


def table_bytes(m, B, slots):
    """The kernels' inputs: the packed float32 node rows, the (slot, row)
    sender and mask tables, the float32 weights."""
    N = m["n_nodes"]
    Np = (N + 7) // 8 * 8
    D = m["particle_input_dim"] + m["n_his"] * 3 + 3
    return B * Np * D * 4 + 2 * B * slots * Np * 4 + n_weights(m) * 4
