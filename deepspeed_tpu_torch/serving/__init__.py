"""Serving-pool control (counterpart of `deepspeed_tpu/serving/`): the
graceful-degradation ladder. The router, replicas and transports are later
slices of the port."""
