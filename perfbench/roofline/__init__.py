"""Published peaks and the bytes and operations the work needs."""
