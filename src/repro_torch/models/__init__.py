"""Model zoo of the port: ``torch.nn`` copies of ``repro.models``, dense
family first (qwen3-4b)."""
