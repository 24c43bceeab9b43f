"""Gradient compression (int8 with error feedback) and the logical-axis
rules (`axes`: logical names -> mesh axes, as pure logic)."""
