"""Model FLOPs of one row through DS-RNN (``robot.policy = "srnn"``,
``reference/bases/srnn.py``), layer by layer; a GRU of input ``i`` and
carry ``H`` counts ``dense(i, 3H) + dense(H, 3H)``: the temporal-edge GRU
over the robot's velocity, a spatial-edge GRU over each of the A
robot-human edges, the attention of the temporal edge over the spatial
ones (the two projections, the scores and the weighted sum), the node GRU
with its embeddings and output layer, the heads."""

from harness.work import dense


def row_flops(snapshot: dict) -> int:
    net, sim = snapshot["network"], snapshot["sim"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    e = 2 if sim["predict_method"] == "none" else 2 * (sim["predict_steps"] + 1)
    emb_e, he = net["human_human_edge_embedding_size"], \
        net["human_human_edge_rnn_size"]
    att, emb = net["attention_size"], net["human_node_embedding_size"]
    h, out = net["human_node_rnn_size"], net["human_node_output_size"]

    def edge(n_in):                       # encoder_linear + GRU(emb_e -> he)
        return dense(n_in, emb_e) + dense(emb_e, 3 * he) + dense(he, 3 * he)

    f = edge(2)                                               # temporal edge
    f += a * edge(e)                                          # spatial edges
    f += dense(he, att) + a * dense(he, att)                  # edge layers
    f += 2 * a * att + 2 * a * he                             # scores, sum
    f += dense(7, 3)                                          # robot_linear
    f += dense(3, emb) + dense(2 * he, emb)                   # node embeds
    f += dense(2 * emb, 3 * h) + dense(h, 3 * h)              # node GRU
    f += dense(h, out)                                        # output_linear
    f += 4 * dense(out, out) + dense(out, 1)                  # critic, actor
    f += dense(out, 2)                                        # fc_mean
    return f
