"""The step's mesh of devices (counterpart of ``edyn_tpu/parallel``): the
reference steps one shard on one device, through the same mesh calls."""
