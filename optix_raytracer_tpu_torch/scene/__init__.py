"""The torch DeviceScene and the built-in Cornell box."""
