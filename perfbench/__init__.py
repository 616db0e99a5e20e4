"""The benchmark of ``bark_tpu_torch`` on one H100 (see README.md)."""
