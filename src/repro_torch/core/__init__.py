"""Core: the paper's concurrent data-loading contribution (loader, fetchers,
workers, sampler), the device prefetch ring, tracing and utilization."""
