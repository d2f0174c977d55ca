"""Training data: the X-Train clip reader and the prefetching loader."""
