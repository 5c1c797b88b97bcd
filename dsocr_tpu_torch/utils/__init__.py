"""Host utilities of the port: checkpoint access without the safetensors
package."""
