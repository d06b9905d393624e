"""The sharded substrate of the port (counterpart of
``repro/distributed``): sharding rules as ``DTensor`` placements on a
``DeviceMesh`` (``sharding``), int8 error-feedback gradient compression
(``compression``), ring attention (``ring_attention``) and the GPipe
schedule (``pipeline``), over ``torch.distributed`` process groups."""
