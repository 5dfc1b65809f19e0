"""Distribution over ranks with ``torch.distributed`` (PyTorch port of
``sympgpr_tpu/distributed/``): process-group start-up and meshes
(``init``), the block-cyclic large-N fit (``large``) and the orbit and
restart sharding (``sharded``)."""
