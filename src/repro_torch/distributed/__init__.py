"""Multi-device pieces of the port (``repro.distributed``): the logical-axis
sharding rules, the H layout of a sharded CNN activation and its
differentiable row exchange, and the re-mesh decision logic (``fault``)."""
