"""Numerics shared by the accuracy policies (``intac``) and the segment-id
utilities (``segmented``)."""
