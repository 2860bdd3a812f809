"""Multi-device execution: the device mesh, the row-sharded tracker, the
Morton-range-sharded map and the 2-D mesh's app loop and tiering."""
