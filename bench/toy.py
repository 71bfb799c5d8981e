"""Small shapes of the benchmark's cells, for its tests on the CPU: the
same code paths as the cells, with the widths of the configuration and
traffic files replaced (`harness.run_cell(..., overrides=...)`)."""

SERVE = {
    "config": {"n_labels": 300, "n_features": 700,
               "assumed": {"serving_model": {"block_density": 0.5,
                                             "weight_std": 0.02},
                           "queries": {"zipf": 1.2, "draws": 40}}},
    "traffic": {"clients": 2, "rows": [2, 8], "pool_rows": 64,
                "max_requests": 5000},
}

TRAIN = {
    "config": {"n_labels": 200, "n_features": 1500, "n_train": 150,
               "labels_per_point": 3.0,
               "assumed": {"train_data": {
                   "beta": 0.9, "pool_size": 6, "pool_stride": 2,
                   "sig_per_label": 3, "bg_per_doc": 20, "bg_zipf": 1.4,
                   "label_noise": 0.05, "max_labels": 8}}},
    "traffic": {"label_batch": 64},
}


def overrides(cell: str) -> dict:
    return TRAIN if cell.endswith(".train") else SERVE
