"""Model FLOPs of one row through the attention-graph base
(``robot.policy = "selfAttn_merge_srnn"``): every dense layer, the
human-human attention with the q/k/v projections folded into one (D, 3D)
product as the kernel runs it, the robot-human attention, the GRU, the
heads."""

from harness.work import dense


def row_flops(snapshot: dict) -> int:
    net, sim = snapshot["network"], snapshot["sim"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    e = 2 if sim["predict_method"] == "none" else 2 * (sim["predict_steps"] + 1)
    d, h = net["attn_size"], net["human_node_rnn_size"]
    out, emb = net["human_node_output_size"], net["human_node_embedding_size"]
    f = dense(2 + 7, 256)                                     # robot_linear
    if net["use_self_attn"]:
        f += a * (dense(e, 128) + dense(128, d))              # embed_0, _1
        f += a * (dense(d, 3 * d) + dense(d, d))              # qkv, out
        f += 2 * 2 * a * a * d                                # QK^T, PV
        f += a * dense(d, 256)                                # spatial_linear
    else:
        f += a * (dense(e, 128) + dense(128, 256))
    if net["use_hr_attn"]:
        att = net["attention_size"]
        f += dense(256, att) + a * dense(256, att)            # edge layers
        f += 2 * a * att + 2 * a * 256                        # scores, sum
    f += 2 * dense(256, emb)                                  # EndRNN embeds
    f += dense(2 * emb, 3 * h) + dense(h, 3 * h)              # GRU
    f += dense(h, out)                                        # output_linear
    f += 4 * dense(out, out) + dense(out, 1)                  # critic, actor
    f += dense(out, 2)                                        # fc_mean
    return f
