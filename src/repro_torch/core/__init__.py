"""Host-side specification model, cost model, partitioner and runtime."""
