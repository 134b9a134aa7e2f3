from . import control  # noqa: F401

# The Qt widgets (qt_gui: GUIDraw, GUIGamut, GUIPalette, GUI_VIS, GUIDesign)
# import PyQt5: import that module directly where a display exists.
