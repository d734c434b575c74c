"""Host-side infrastructure the port needs: task tracing."""
