"""Measurement scripts run on the card against a checkout of the port
(``python3 deeplearning4j_tpu_torch/tools/<script>.py --help``). Importing
this package runs nothing."""
