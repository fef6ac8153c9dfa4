"""Test-support utilities of the port (not test code): ``faults``, the
fault injectors behind the robustness tests."""
