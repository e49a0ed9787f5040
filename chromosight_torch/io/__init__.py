"""IO without pandas: kernel configs, contact sources and writers."""
