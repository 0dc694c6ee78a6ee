"""Host-side network helpers of the port."""
