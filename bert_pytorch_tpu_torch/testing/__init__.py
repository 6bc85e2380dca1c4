"""Test and chaos helpers of the port."""
