"""Scale-out over several processes: channel sharding and time slabs on
``torch.distributed`` (port of ``m17_sdr_tpu.mesh``)."""
