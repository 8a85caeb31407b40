"""rwkv6_wkv: the RWKV-6 WKV recurrence, as a CUDA kernel."""
