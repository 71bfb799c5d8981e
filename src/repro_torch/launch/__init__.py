"""Command-line entry points of the port: `python -m repro_torch.launch.serve
--xmc [--server]` and `python -m repro_torch.launch.train --xmc`, each with
`--device` (cuda by default, or cpu)."""
