"""Launch scripts of the port: ``python -m deepspeed_tpu_torch.scripts.<name>``
(``serve_replica``, ``serve_frontend``, ``fleetctl``)."""
