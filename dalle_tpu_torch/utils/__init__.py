"""Small shared utilities of the port (a copy of ``dalle_tpu/utils``' retry)."""
