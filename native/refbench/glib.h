/* Minimal glib typedef shim.
 *
 * Lets the reference's autogenerated ORC backup C files
 * (e.g. /root/reference/gst/gaudieffects/gstgaudieffectsorc-dist.c, which
 * only needs the g* integer typedefs from <glib.h>) compile standalone on a
 * host without glib, with -DDISABLE_ORC selecting their pure-C emulation
 * path.  Used ONLY by tools/ref_baseline.py to produce the compiled-C
 * single-core baseline in BASELINE_C.json; never linked into the framework.
 */
#ifndef GSTBAD_REFBENCH_GLIB_SHIM_H
#define GSTBAD_REFBENCH_GLIB_SHIM_H

#include <stdint.h>

typedef int8_t gint8;
typedef uint8_t guint8;
typedef int16_t gint16;
typedef uint16_t guint16;
typedef int32_t gint32;
typedef uint32_t guint32;
typedef int64_t gint64;
typedef uint64_t guint64;
typedef int gint;
typedef unsigned int guint;
typedef int gboolean;
typedef char gchar;
typedef void *gpointer;

#endif
