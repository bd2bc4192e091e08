"""Host-side helpers of the port: FLOP accounting and parameter trees."""
