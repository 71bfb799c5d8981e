"""Share of the window in which the device idled while the training
thread copied between host and device: X to the host, a batch's sign rows
to the device, its solved rows back, the model assembled and sent
(`train.x_to_host`, `train.signs`, `train.rows_d2h`,
`train.materialize`)."""

from bench import spans


def read(run):
    return spans.idle_share(run, "train.x_to_host", "train.signs",
                            "train.rows_d2h", "train.materialize")
