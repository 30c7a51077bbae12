"""Operations and bytes of the rollout kernel (K1, ``csrc/rollout_chunk.cu``)
on a chunk's inputs: the matmul FLOPs of the particle encoder, the
propagator base and round 1's receiver and sender products once a sample
(the effect starts from the particle encoding), the other node-sized
products per substep a sample runs, and the relation MLP per real edge;
every input read once and the output written once. ``sample_steps`` and
``edges`` are the substeps the samples run and the real edges over them,
as the reference counts them on these inputs."""


def work(m, B, sample_steps, edges, act_bytes=2):
    N, n_p, nf = m["n_nodes"], m["max_nobj"], m["nf_effect"]
    nfp, nfr, rin = m["nf_particle"], m["nf_relation"], m["relation_input_dim"]
    Dp = m["particle_input_dim"]
    Np = (N + 7) // 8 * 8
    recv_send = 2 * N * nf * 2 * nf
    per_sample = 2 * N * (Dp * nfp + nfp * nfp + nfp * nf) + 2 * N * nf * nf + recv_send
    per_step = ((m["pstep"] - 1) * recv_send + m["pstep"] * 2 * N * nf * nf
                + 2 * n_p * (2 * nf * nf + 3 * nf))
    per_edge = 2 * (rin * nfr + nfr * nfr + nfr * nf + nf * nf)
    ops = B * per_sample + sample_steps * per_step + edges * per_edge
    n_weights = (Dp * nfp + nfp + nfp * nfp + nfp + nfp * nf + nf
                 + rin * nfr + nfr + nfr * nfr + nfr + nfr * nf + nf
                 + nf * nf + nf * 2 * nf + nf + nf * nf + nf * nf + nf
                 + nf * nf + nf + nf * nf + nf + nf * 3 + 3)
    nbytes = (B * Np * Dp * act_bytes      # packed node inputs
              + B * Np * 6 * 4             # start state and pusher move
              + B * n_p * 3 * 4            # output
              + n_weights * act_bytes
              + B * 4 + B * Np * 4)        # repeats, row validity
    return ops, nbytes
