"""Host-side helpers of the port (counterpart of arrow1_tpu/utils)."""
