"""Multi-device pieces of the port (``repro.distributed``): the logical-axis
sharding rules and the H layout of a sharded CNN activation."""
