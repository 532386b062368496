/* In-repo frei0r fixture plugins for the plugin-host tests
 * (the native/ladspa_plugins.c pattern applied to the f0r ABI).
 *
 * frei0r requires ONE plugin per shared object (frei0r.h spec), so
 * this file compiles once per plugin with -DF0R_FIXTURE_<NAME>:
 *   brightness  - BGRA8888 filter; double "level" [0,1] scales RGB by
 *                 2*level (level 0.5 = identity), bool "invert"
 *                 inverts RGB after scaling.  Alpha untouched.
 *   gradient    - BGRA8888 source; paints B = x ramp, G = y ramp,
 *                 R = time*25.5 (mod 256), A = 255; color param
 *                 "tint" multiplies the three channels.
 *   blend       - BGRA8888 mixer2; out = a*(1-mix) + b*mix with
 *                 double "mix"; position param "anchor" is stored and
 *                 readable (marshalling coverage), not used in math.
 *   labeler     - PACKED32 filter with a string param "tag"; copies
 *                 input and writes strlen(tag) into the first byte of
 *                 pixel 0 (observable, deterministic).
 *
 * ABI per /root/reference/gst/frei0r/frei0r.h (public header):
 * f0r_init/deinit, get_plugin_info, get_param_info, construct,
 * destruct, set/get_param_value, update (+update2 for the mixer).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- minimal f0r ABI declarations (public header layout) ---- */
typedef struct {
  const char *name;
  const char *author;
  int plugin_type;
  int color_model;
  int frei0r_version;
  int major_version;
  int minor_version;
  int num_params;
  const char *explanation;
} f0r_plugin_info_t;

typedef struct {
  const char *name;
  int type;
  const char *explanation;
} f0r_param_info_t;

typedef struct { float r, g, b; } f0r_param_color_t;
typedef struct { double x, y; } f0r_param_position_t;

#define F0R_PLUGIN_TYPE_FILTER 0
#define F0R_PLUGIN_TYPE_SOURCE 1
#define F0R_PLUGIN_TYPE_MIXER2 2
#define F0R_COLOR_MODEL_BGRA8888 0
#define F0R_COLOR_MODEL_PACKED32 2
#define F0R_PARAM_BOOL 0
#define F0R_PARAM_DOUBLE 1
#define F0R_PARAM_COLOR 2
#define F0R_PARAM_POSITION 3
#define F0R_PARAM_STRING 4

int f0r_init (void) { return 1; }
void f0r_deinit (void) { }

static inline uint8_t clamp_u8 (double v)
{
  if (v < 0) return 0;
  if (v > 255) return 255;
  return (uint8_t) v;
}

/* ======================================================= brightness */
#if defined(F0R_FIXTURE_BRIGHTNESS)

typedef struct { unsigned w, h; double level; double invert; } inst_t;

void f0r_get_plugin_info (f0r_plugin_info_t * info)
{
  info->name = "fixbrightness";
  info->author = "gstbad fixtures";
  info->plugin_type = F0R_PLUGIN_TYPE_FILTER;
  info->color_model = F0R_COLOR_MODEL_BGRA8888;
  info->frei0r_version = 1;
  info->major_version = 1;
  info->minor_version = 0;
  info->num_params = 2;
  info->explanation = "scale RGB by 2*level, optional invert";
}

void f0r_get_param_info (f0r_param_info_t * info, int idx)
{
  if (idx == 0) {
    info->name = "level";
    info->type = F0R_PARAM_DOUBLE;
    info->explanation = "0.5 = identity";
  } else {
    info->name = "invert";
    info->type = F0R_PARAM_BOOL;
    info->explanation = "invert RGB after scaling";
  }
}

void *f0r_construct (unsigned w, unsigned h)
{
  inst_t *i = calloc (1, sizeof (inst_t));
  i->w = w;
  i->h = h;
  i->level = 0.5;           /* defaults set here per spec 1.2 */
  i->invert = 0.0;
  return i;
}

void f0r_destruct (void *inst) { free (inst); }

void f0r_set_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  if (idx == 0)
    i->level = *(double *) param;
  else
    i->invert = *(double *) param;
}

void f0r_get_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  *(double *) param = idx == 0 ? i->level : i->invert;
}

void f0r_update (void *inst, double time, const uint32_t * in,
    uint32_t * out)
{
  inst_t *i = inst;
  double gain = 2.0 * i->level;
  int inv = i->invert >= 0.5;
  unsigned n = i->w * i->h, k;
  (void) time;
  for (k = 0; k < n; k++) {
    const uint8_t *p = (const uint8_t *) (in + k);
    uint8_t *q = (uint8_t *) (out + k);
    int c;
    for (c = 0; c < 3; c++) {   /* B, G, R */
      uint8_t v = clamp_u8 (p[c] * gain);
      q[c] = inv ? 255 - v : v;
    }
    q[3] = p[3];
  }
}

/* ========================================================= gradient */
#elif defined(F0R_FIXTURE_GRADIENT)

typedef struct { unsigned w, h; f0r_param_color_t tint; } inst_t;

void f0r_get_plugin_info (f0r_plugin_info_t * info)
{
  info->name = "fixgradient";
  info->author = "gstbad fixtures";
  info->plugin_type = F0R_PLUGIN_TYPE_SOURCE;
  info->color_model = F0R_COLOR_MODEL_BGRA8888;
  info->frei0r_version = 1;
  info->major_version = 1;
  info->minor_version = 0;
  info->num_params = 1;
  info->explanation = "x/y/time gradient source";
}

void f0r_get_param_info (f0r_param_info_t * info, int idx)
{
  (void) idx;
  info->name = "tint";
  info->type = F0R_PARAM_COLOR;
  info->explanation = "per-channel multiplier";
}

void *f0r_construct (unsigned w, unsigned h)
{
  inst_t *i = calloc (1, sizeof (inst_t));
  i->w = w;
  i->h = h;
  i->tint.r = i->tint.g = i->tint.b = 1.0f;
  return i;
}

void f0r_destruct (void *inst) { free (inst); }

void f0r_set_param_value (void *inst, void *param, int idx)
{
  (void) idx;
  ((inst_t *) inst)->tint = *(f0r_param_color_t *) param;
}

void f0r_get_param_value (void *inst, void *param, int idx)
{
  (void) idx;
  *(f0r_param_color_t *) param = ((inst_t *) inst)->tint;
}

void f0r_update (void *inst, double time, const uint32_t * in,
    uint32_t * out)
{
  inst_t *i = inst;
  unsigned x, y;
  uint8_t t = (uint8_t) ((int) (time * 25.5) & 0xFF);
  (void) in;
  for (y = 0; y < i->h; y++)
    for (x = 0; x < i->w; x++) {
      uint8_t *q = (uint8_t *) (out + y * i->w + x);
      q[0] = clamp_u8 ((x & 0xFF) * i->tint.b);
      q[1] = clamp_u8 ((y & 0xFF) * i->tint.g);
      q[2] = clamp_u8 (t * i->tint.r);
      q[3] = 255;
    }
}

/* ============================================================ blend */
#elif defined(F0R_FIXTURE_BLEND)

typedef struct { unsigned w, h; double mix; f0r_param_position_t anchor;
} inst_t;

void f0r_get_plugin_info (f0r_plugin_info_t * info)
{
  info->name = "fixblend";
  info->author = "gstbad fixtures";
  info->plugin_type = F0R_PLUGIN_TYPE_MIXER2;
  info->color_model = F0R_COLOR_MODEL_BGRA8888;
  info->frei0r_version = 1;
  info->major_version = 1;
  info->minor_version = 0;
  info->num_params = 2;
  info->explanation = "linear blend of two inputs";
}

void f0r_get_param_info (f0r_param_info_t * info, int idx)
{
  if (idx == 0) {
    info->name = "mix";
    info->type = F0R_PARAM_DOUBLE;
    info->explanation = "0 = input1, 1 = input2";
  } else {
    info->name = "anchor";
    info->type = F0R_PARAM_POSITION;
    info->explanation = "stored only (marshalling coverage)";
  }
}

void *f0r_construct (unsigned w, unsigned h)
{
  inst_t *i = calloc (1, sizeof (inst_t));
  i->w = w;
  i->h = h;
  i->mix = 0.5;
  i->anchor.x = 0.25;
  i->anchor.y = 0.75;
  return i;
}

void f0r_destruct (void *inst) { free (inst); }

void f0r_set_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  if (idx == 0)
    i->mix = *(double *) param;
  else
    i->anchor = *(f0r_param_position_t *) param;
}

void f0r_get_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  if (idx == 0)
    *(double *) param = i->mix;
  else
    *(f0r_param_position_t *) param = i->anchor;
}

void f0r_update2 (void *inst, double time, const uint32_t * in1,
    const uint32_t * in2, const uint32_t * in3, uint32_t * out)
{
  inst_t *i = inst;
  unsigned n = i->w * i->h, k;
  (void) time;
  (void) in3;
  for (k = 0; k < n; k++) {
    const uint8_t *a = (const uint8_t *) (in1 + k);
    const uint8_t *b = (const uint8_t *) (in2 + k);
    uint8_t *q = (uint8_t *) (out + k);
    int c;
    for (c = 0; c < 4; c++)
      q[c] = clamp_u8 (a[c] * (1.0 - i->mix) + b[c] * i->mix);
  }
}

/* ========================================================== labeler */
#elif defined(F0R_FIXTURE_LABELER)

typedef struct { unsigned w, h; char tag[256]; } inst_t;

void f0r_get_plugin_info (f0r_plugin_info_t * info)
{
  info->name = "fixlabeler";
  info->author = "gstbad fixtures";
  info->plugin_type = F0R_PLUGIN_TYPE_FILTER;
  info->color_model = F0R_COLOR_MODEL_PACKED32;
  info->frei0r_version = 1;
  info->major_version = 1;
  info->minor_version = 0;
  info->num_params = 1;
  info->explanation = "string param coverage";
}

void f0r_get_param_info (f0r_param_info_t * info, int idx)
{
  (void) idx;
  info->name = "tag";
  info->type = F0R_PARAM_STRING;
  info->explanation = "strlen lands in pixel 0 byte 0";
}

void *f0r_construct (unsigned w, unsigned h)
{
  inst_t *i = calloc (1, sizeof (inst_t));
  i->w = w;
  i->h = h;
  strcpy (i->tag, "f0r");
  return i;
}

void f0r_destruct (void *inst) { free (inst); }

void f0r_set_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  (void) idx;
  /* string params pass char** (frei0r.h f0r_param_string) */
  strncpy (i->tag, *(char **) param, 255);
  i->tag[255] = 0;
}

void f0r_get_param_value (void *inst, void *param, int idx)
{
  inst_t *i = inst;
  (void) idx;
  *(char **) param = i->tag;
}

void f0r_update (void *inst, double time, const uint32_t * in,
    uint32_t * out)
{
  inst_t *i = inst;
  (void) time;
  memcpy (out, in, (size_t) i->w * i->h * 4);
  ((uint8_t *) out)[0] = (uint8_t) strlen (i->tag);
}

#else
#error "compile with -DF0R_FIXTURE_<NAME>"
#endif
